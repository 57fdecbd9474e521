"""Dynamic micro-batching inference engine (counterpart:
``deeplearning4j_tpu/serving/engine.py``; ref: deeplearning4j
ParallelInference's InferenceMode.BATCHED, whose BatchedInferenceObservable
coalesces concurrent observers into one model pass).

One background dispatcher thread coalesces every caller's rows into one
batch per device pass, so k concurrent 1-row calls cost about one forward
instead of k. Two serving invariants on top:

- **bounded batch shapes.** Batches are padded up to a small geometric
  ladder of bucket sizes (:func:`bucket_ladder`), so at most
  ``len(buckets)`` batch shapes ever reach the model — the reference
  bounds its XLA executables this way; the port runs eagerly, and the
  ladder bounds the GEMM shapes cuBLAS and the attention kernels see.
  First sight of each bucket is counted per bucket in
  :class:`~deeplearning4j_tpu_torch.serving.metrics.ServingMetrics`.
- **bounded queueing.** Admission control (admission.py) turns overload
  into typed :class:`RejectedError`\\ s instead of unbounded latency.

Determinism: pad rows are zeros and outputs are sliced back per request,
so each caller's result is bitwise the rows of a direct ``adapter.infer``
call on the same padded bucket batch.

Resilience and observability are the generation engine's
(:class:`~.resilience.ResilientEngineMixin`): the ``engine.dispatch`` and
``engine.warmup`` fault points, bounded retry, the breaker, the watchdog,
the NaN/inf output screen, tracing and the resource ledger.

Under a ``mesh`` (:mod:`deeplearning4j_tpu_torch.parallel.mesh`) every
rank of the mesh builds the engine with the same arguments over an
adapter that shards its model on the mesh (``CausalLMAdapter(mesh=)``).
The mesh's first rank batches the requests, pads each batch to a bucket
that is a multiple of the 'data' axis, and sends the padded batch to the
other ranks before its own call (serving/sharded.py); every rank calls
the adapter on the same batch, and each receives the whole output.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS
from deeplearning4j_tpu_torch.profiler import OpProfiler
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionController, DeadlineExceededError, HostDrainingError,
    QueueFullError, RejectedError, Request,
)
from deeplearning4j_tpu_torch.serving.faults import inject
from deeplearning4j_tpu_torch.serving.ledger import track_engine
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.qos import SloBurnGovernor, resolve_qos
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker, CircuitOpenError, PoisonedResultError,
    ResilientEngineMixin, RetryPolicy, WatchdogTimeoutError,
)
from deeplearning4j_tpu_torch.serving.sharded import (
    PlanChannel, bind_card, card_of, driver_only)
from deeplearning4j_tpu_torch.serving.tracing import terminal_reason


def bucket_ladder(max_batch_size: int, multiple_of: int = 1,
                  min_bucket: int = 1) -> Tuple[int, ...]:
    """Geometric (doubling) ladder of buckets ending at or above
    ``max_batch_size``, every rung a multiple of ``multiple_of``."""
    if max_batch_size <= 0:
        raise ValueError("max_batch_size must be positive")
    base = max(min_bucket, multiple_of)
    base = ((base + multiple_of - 1) // multiple_of) * multiple_of
    out = [base]
    while out[-1] < max_batch_size:
        out.append(out[-1] * 2)
    return tuple(out)


class InferenceEngine(ResilientEngineMixin):
    """Future-based batching front end for one deployed model.

    ``submit(x)`` enqueues ``x`` (batch-major, 1..max_batch_size rows) and
    returns a :class:`concurrent.futures.Future` that resolves to a numpy
    array of exactly ``x.shape[0]`` output rows; the dispatcher coalesces
    queued requests into one padded bucket batch per device pass.
    ``output(x)`` is the blocking form.

    ``max_batch_size`` is the reference Builder's batchLimit,
    ``max_wait_ms`` the batching window, ``queue_capacity_rows`` and
    ``default_timeout_ms`` the admission bounds, ``buckets`` overrides the
    padding ladder. ``tracer`` opts into request tracing (serving/
    tracing.py), ``screen_outputs`` is the NaN/inf guard on every
    dispatch output, ``qos`` (serving/qos.py ``QosPolicy``) swaps
    admission's FIFO for priority-strict weighted-fair queueing with
    per-tenant quotas and SLO-burn shedding, ``retry_budget`` bounds retry
    amplification. ``mesh`` serves a model sharded over a mesh of ranks
    (every rank builds the engine; the first takes the submits, the
    others follow its batches): the ladder's rungs are multiples of the
    mesh's 'data' size (serving/sharded.py)."""

    _COMPONENT = "serving.InferenceEngine"
    _FAILURE_NOUN = "dispatch"

    def __init__(self, model, *, mesh=None, max_batch_size: int = 32,
                 max_wait_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None,
                 queue_capacity_rows: int = 1024,
                 default_timeout_ms: Optional[float] = None,
                 metrics: Optional[ServingMetrics] = None,
                 profiler: Optional[OpProfiler] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_budget=None, qos=None,
                 watchdog_timeout_ms: Optional[float] = None,
                 tracer=None, recorder=None, screen_outputs: bool = True,
                 name: str = "engine"):
        from deeplearning4j_tpu_torch.serving.registry import (
            ModelAdapter, as_adapter)

        self.adapter = model if isinstance(model, ModelAdapter) \
            else as_adapter(model)
        self.mesh = mesh
        self._n = mesh.axis_size(DATA_AXIS) if mesh is not None else 1
        self.device = getattr(self.adapter, "device", None)
        if self.device is not None:
            self.device = card_of(self.device)
        if max_batch_size <= 0:
            raise ValueError("max_batch_size must be positive")
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        if buckets is None:
            self.buckets = bucket_ladder(max_batch_size, multiple_of=self._n)
        else:
            self.buckets = tuple(sorted(set(int(b) for b in buckets)))
            if not self.buckets or self.buckets[-1] < max_batch_size:
                raise ValueError(
                    f"buckets {self.buckets} must cover max_batch_size "
                    f"{max_batch_size}")
            if any(b % self._n for b in self.buckets):
                raise ValueError(
                    f"every bucket must be a multiple of the mesh data-axis "
                    f"size {self._n}: {self.buckets}")
        self.name = name
        self.metrics = metrics or ServingMetrics()
        self.profiler = profiler or OpProfiler.getInstance()
        # multi-tenant QoS: a policy swaps admission's FIFO for the
        # weighted-fair multi-queue with quota metering and arms the
        # SLO-burn governor; qos=None keeps the plain FIFO path
        self.qos = qos
        self._qos_governor = SloBurnGovernor(qos, self.metrics) \
            if qos is not None else None
        self._admission = AdmissionController(
            capacity_rows=queue_capacity_rows,
            default_timeout_ms=default_timeout_ms, policy=qos)
        self._admission.on_shed = self._count_shed
        self._admission.on_close_reject = self._count_close_reject
        self._admission.on_cancelled = self._count_cancelled
        self._seen_buckets: set = set()
        self._row_sig = None  # (feature shape, dtype) pinned by first request
        self._seen_lock = threading.Lock()
        self._draining = False
        self._stop = threading.Event()
        self.screen_outputs = screen_outputs
        self._init_resilience(retry_policy=retry_policy, breaker=breaker,
                              retry_budget=retry_budget,
                              tracer=tracer, recorder=recorder)
        self._inflight: List[Request] = []
        self._plan = PlanChannel(mesh) if mesh is not None else None
        if self._plan is not None and not self._plan.is_driver:
            # a follower: the driver's batches come as plans
            self._thread = None
            self._plan.follow(self._follow)
            track_engine(self)
            return
        self._thread = threading.Thread(
            target=self._loop, args=(0,),
            name=f"serving-dispatcher[{self.name}]", daemon=True)
        self._thread.start()
        if watchdog_timeout_ms is not None:
            self.arm_watchdog(watchdog_timeout_ms)
        track_engine(self)   # weak: the zero-leak ledger's registry

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self, wait: bool = True):
        """Stop the dispatcher; queued requests are rejected ('shutdown')."""
        self._shutdown_resilience()   # watchdog off, breaker detached
        self._stop.set()
        self._admission.close()
        self._recorder.record("engine.shutdown", engine=self.name)
        if self._thread is not None and wait and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if self._plan is not None and (wait or self._plan.is_driver):
            self._plan.close()   # the driver's last plan; a follower waits

    @property
    def is_driver(self) -> bool:
        """False on a mesh engine's followers (submit raises there)."""
        return self._plan is None or self._plan.is_driver

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain (the host-leave protocol's engine half): new
        submits shed typed ``host_draining``, then wait for every queued
        and in-flight request to finish. True when fully drained within
        ``timeout`` (None = wait forever). The dispatcher keeps running;
        ``shutdown()`` is the usual next step."""
        return self._drain_wait(timeout)

    # --------------------------------------------------------------- submit
    def submit(self, x, timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: Optional[str] = None,
               trace_link: Optional[str] = None,
               trace_parent: Optional[str] = None) -> Future:
        """Enqueue a batch-major array; the Future resolves to a numpy
        array holding exactly ``x.shape[0]`` output rows, or raises
        :class:`RejectedError` / the model's own exception. ``tenant``
        and ``priority`` attribute the request for QoS (accounting labels
        only without a ``qos=`` policy). ``trace_link``/``trace_parent``
        attach the request's trace to a cross-host parent (see
        serving/rpc.py); by default it is a local root. On a mesh only
        the driver takes submits."""
        if not self.is_driver:
            raise driver_only(self, "submit")
        arr = np.asarray(x)
        if arr.ndim < 1 or arr.shape[0] == 0:
            raise ValueError("submit() needs a batch-major array with >=1 row")
        if arr.shape[0] > self.max_batch_size:
            raise ValueError(
                f"request of {arr.shape[0]} rows exceeds max_batch_size "
                f"{self.max_batch_size}; split the call")
        tenant, priority = resolve_qos(self.qos, tenant, priority)
        self._check_row_sig(arr.shape[1:], arr.dtype)
        self._count_request()
        trace = self._tracer.begin(self.name, "infer", link=trace_link,
                                   parent_span=trace_parent,
                                   rows=int(arr.shape[0]), tenant=tenant)
        if self._draining:
            # drain outranks every other gate: the host is leaving and
            # the router should place this elsewhere
            e = HostDrainingError(
                f"engine[{self.name}] is draining — admission closed "
                "ahead of a graceful leave; route to another host")
            self._reject_submit(trace, e, tenant=tenant)
            raise e
        self._breaker_gate(trace, tenant=tenant)
        if self._qos_governor is not None:
            e = self._qos_governor.gate(priority)
            if e is not None:
                self._reject_submit(trace, e, tenant=tenant)
                raise e
        req = Request(x=arr, rows=int(arr.shape[0]), trace=trace,
                      tenant=tenant, priority=priority)
        try:
            self._admission.admit(req, timeout_ms=timeout_ms)
        except RejectedError as e:
            self._reject_submit(trace, e, tenant=tenant)
            raise
        self.metrics.queue_depth.set(self._admission.depth_rows)
        return req.future

    def output(self, x, timeout_ms: Optional[float] = None,
               **submit_kwargs) -> np.ndarray:
        """Blocking submit (ref: ParallelInference.output)."""
        return self.submit(x, timeout_ms=timeout_ms, **submit_kwargs).result()

    def _check_row_sig(self, feature_shape, dtype):
        """Every request to one engine shares one feature shape and dtype
        (pinned by the first request or warmup): co-batched rows are
        concatenated, so a mismatch would fail the whole batch (shape) or
        silently upcast the neighbours' rows (dtype)."""
        sig = (tuple(feature_shape), np.dtype(dtype))
        with self._seen_lock:
            if self._row_sig is None:
                self._row_sig = sig
            elif sig != self._row_sig:
                raise ValueError(
                    f"request rows {sig} do not match this engine's pinned "
                    f"row signature {self._row_sig}; one engine serves one "
                    f"input surface — use a second engine for other inputs")

    # -------------------------------------------------------------- batching
    def _loop(self, epoch: int):
        """Dispatcher loop for one epoch. A watchdog restart bumps
        ``_epoch``: this (possibly wedged) thread exits at its next check
        instead of racing its replacement, and result delivery tolerates
        futures the watchdog already failed."""
        bind_card(self.device)
        while not self._stop.is_set() and self._epoch == epoch:
            if self._watchdog is not None:
                self._watchdog.beat()
            # the QoS multi-queue can starve a low-weight tenant's queue
            # while others have traffic, so its expired entries are swept
            # every turn; the FIFO sheds lazily at its head and sweeps on
            # the idle tick only
            if self.qos is not None:
                self._admission.expire_queued()
            first = self._admission.take(self.max_batch_size, timeout=0.05)
            if first is None:
                if self.qos is None:
                    self._admission.expire_queued()
                continue
            batch = [first]
            rows = first.rows
            t_open = time.perf_counter()
            window = self.max_wait_ms / 1000.0
            while rows < self.max_batch_size:
                remaining = t_open + window - time.perf_counter()
                if remaining <= 0:
                    break
                nxt = self._admission.take(self.max_batch_size - rows,
                                           timeout=remaining)
                if nxt is None:  # window elapsed, or head won't fit: seal
                    break
                batch.append(nxt)
                rows += nxt.rows
            with self._wd_lock:   # visible to the watchdog while on-device
                self._inflight = list(batch)
            try:
                self._dispatch(batch)
            except BaseException as e:  # never kill the dispatcher thread
                reason = terminal_reason(e)
                for req in batch:
                    if not req.future.done():
                        try:
                            req.future.set_exception(e)
                            self._finish_request(req.trace, reason,
                                                 tenant=req.tenant)
                        except InvalidStateError:
                            pass
            finally:
                with self._wd_lock:
                    # a restart mid-dispatch handed _inflight to the
                    # replacement: this stale thread must not clear it
                    if self._epoch == epoch:
                        self._inflight = []
        # reject what was admitted between close() and loop exit — the
        # current epoch's thread only: a stale thread must not reject
        # work its replacement is about to serve
        if self._stop.is_set() and self._epoch == epoch:
            while True:
                req = self._admission.take(self.max_batch_size, timeout=0.0)
                if req is None:
                    break
                if req.future.done():
                    # a queued future is done only if its caller
                    # cancelled it: that terminal counts too
                    self._count_cancelled(req)
                    continue
                try:
                    req.future.set_exception(
                        RejectedError("engine shut down", "shutdown"))
                except InvalidStateError:
                    self._count_cancelled(req)   # cancel won the race
                    continue
                self.metrics.record_rejection("shutdown")
                self._finish_request(req.trace, "shutdown",
                                     tenant=req.tenant)

    # ------------------------------------------------------------- watchdog
    def _watchdog_busy(self) -> bool:
        with self._wd_lock:
            if self._inflight:
                return True
        return self._admission.depth_requests > 0

    def _watchdog_stall(self):
        """The dispatcher stopped heartbeating with work outstanding: fail
        the in-flight batch typed (callers get an answer now), stale the
        wedged thread through the epoch, and start a fresh dispatcher over
        the same admission queue — queued requests are kept, and every
        delivery path tolerates an already-resolved future."""
        with self._wd_lock:
            self._epoch += 1
            epoch = self._epoch
            victims, self._inflight = self._inflight, []
        exc = WatchdogTimeoutError(
            f"engine[{self.name}] dispatcher missed its heartbeat for "
            f">{self._watchdog.timeout_s * 1e3:.0f} ms with "
            f"{len(victims)} request(s) in flight; batch failed, "
            f"dispatcher restarted")
        failed = 0
        for req in victims:
            req.trace.event("watchdog.restart", epoch=epoch)
            try:
                req.future.set_exception(exc)
                failed += 1
                self._finish_request(req.trace, "watchdog",
                                     tenant=req.tenant)
            except InvalidStateError:
                pass
        if failed:
            self.metrics.failed_total.inc(failed)
        self.metrics.watchdog_restarts.inc()
        self.metrics.record_rejection("watchdog")
        self._recorder.record("watchdog.restart", engine=self.name,
                              epoch=epoch, victims=len(victims))
        self._breaker.record_failure()
        self._thread = threading.Thread(
            target=self._loop, args=(epoch,),
            name=f"serving-dispatcher[{self.name}]#{epoch}", daemon=True)
        self._thread.start()

    def _bucket_for(self, b: int) -> int:
        for s in self.buckets:
            if s >= b:
                return s
        return self.buckets[-1]

    def _guarded_run(self, x: np.ndarray) -> np.ndarray:
        """The resilient device call: the ``engine.dispatch`` fault point
        and bounded retry. Safe to retry because futures resolve only after
        the final outcome — a retried batch cannot deliver twice."""
        def call():
            return np.asarray(inject("engine.dispatch", self._run, x))

        return self._retry_call(call)

    def _run(self, x: np.ndarray):
        """The adapter's call on one padded batch; on a mesh the batch
        goes to the other ranks first, and each calls its adapter too."""
        if self._plan is None:
            return self.adapter.infer(x)
        return self._plan.run({"op": "infer", "x": x},
                              lambda: self.adapter.infer(x))

    def _follow(self, plan: dict):
        """A follower's half of the driver's batch."""
        bind_card(self.device)
        if plan["op"] != "infer":
            raise ValueError(f"unknown plan {plan['op']!r}")
        self.adapter.infer(plan["x"])

    # ------------------------------------------- ResilientEngineMixin hooks
    def _retry_traces(self):
        with self._wd_lock:
            return [r.trace for r in self._inflight]

    def _crash_dump_model(self):
        return self.adapter.model

    def _dispatch(self, batch):
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.expired(now):  # re-check: the window may have eaten it
                self._admission._shed(req)  # counts via _count_shed
            elif not req.future.set_running_or_notify_cancel():
                # caller cancelled while queued: drop silently
                self._finish_request(req.trace, "cancelled",
                                     tenant=req.tenant)
                continue
            else:
                qw = (now - req.submit_t) * 1e3
                self.metrics.queue_wait_ms.observe(qw)
                self.metrics.observe_queue_wait_class(req.priority, qw)
                req.trace.event("queue.wait", queue_wait_ms=round(qw, 3),
                                batch_requests=len(batch))
                live.append(req)
        self.metrics.queue_depth.set(self._admission.depth_rows)
        if not live:
            return
        b = sum(r.rows for r in live)
        x = live[0].x if len(live) == 1 else np.concatenate([r.x for r in live])
        bucket = self._bucket_for(b)
        if bucket > b:
            pad = np.zeros((bucket - b,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad])
        with self._seen_lock:
            first_time = bucket not in self._seen_buckets
            self._seen_buckets.add(bucket)
        self.metrics.inflight_rows.set(bucket)
        t0 = time.perf_counter()
        try:
            with self.profiler.span("serving.dispatch", engine=self.name,
                                    bucket=bucket, rows=b,
                                    requests=len(live)):
                y = self._guarded_run(x)
            if self.screen_outputs:
                self._screen_finite(y, "engine.dispatch")
        except BaseException as e:
            self.metrics.failed_total.inc(len(live))
            self._breaker.record_failure()
            if not getattr(e, "injected", False) \
                    and not isinstance(e, PoisonedResultError):
                # poisoned and injected failures flight-record themselves;
                # recorded before the dump so the dump's snapshot has it
                self._recorder.record(
                    "dispatch.failed", engine=self.name, bucket=bucket,
                    requests=len(live), error=type(e).__name__)
            self._maybe_crash_dump(e, bucket=bucket, requests=len(live))
            reason = terminal_reason(e)
            fail_t = time.perf_counter()
            for req in live:
                req.trace.event("dispatch.failed", error=type(e).__name__)
                try:
                    req.future.set_exception(e)
                    self._finish_request(
                        req.trace, reason,
                        latency_ms=(fail_t - req.submit_t) * 1e3,
                        tenant=req.tenant)
                except InvalidStateError:
                    pass  # watchdog or caller got there first
            return
        finally:
            self.metrics.inflight_rows.set(0)
        self._breaker.record_success()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.batches_total.inc()
        self.metrics.rows_total.inc(b)
        self.metrics.padded_rows_total.inc(bucket - b)
        self.metrics.requests_per_batch.observe(len(live))
        self.metrics.fill_ratio.observe(b / bucket)
        self.metrics.dispatch_ms.observe(dt_ms)
        self.metrics.record_bucket(bucket, b, first_time)
        off = 0
        done_t = time.perf_counter()
        for req in live:
            # copy: a view would pin the whole bucket buffer (pad rows and
            # other tenants' outputs) for as long as the caller holds it
            out = y[off:off + req.rows].copy()
            off += req.rows
            lat = (done_t - req.submit_t) * 1e3
            self.metrics.latency_ms.observe(lat)
            req.trace.event("dispatch", dur_ms=round(dt_ms, 3),
                            bucket=bucket, rows=req.rows)
            try:
                req.future.set_result(out)
                self._finish_request(req.trace, "ok", latency_ms=lat,
                                     tenant=req.tenant)
            except InvalidStateError:
                pass  # failed by the watchdog while this stale thread ran

    # --------------------------------------------------------------- warmup
    def warmup(self, example_row) -> "InferenceEngine":
        """Run every bucket once from one example row (feature shape, no
        batch dim), through the ``engine.warmup`` fault point: the
        reference compiles each bucket's executable here; the port's
        first call at each shape sets up cuBLAS's plans and the caching
        allocator's blocks, off the live traffic's path. A mesh engine's
        followers return at once: they run the driver's warmup batches."""
        from deeplearning4j_tpu_torch.serving.registry import tile_rows

        if not self.is_driver:
            return self
        ex = np.asarray(example_row)
        self._check_row_sig(ex.shape, ex.dtype)
        for bucket in self.buckets:
            x = tile_rows(ex, bucket)
            with self._seen_lock:
                first_time = bucket not in self._seen_buckets
                self._seen_buckets.add(bucket)
            with self.profiler.span("serving.warmup", engine=self.name,
                                    bucket=bucket):
                np.asarray(inject("engine.warmup", self._run, x))
            self.metrics.record_bucket(bucket, 0, first_time)
        return self

    # -------------------------------------------------------------- insight
    def compiled_signatures(self) -> int:
        """Batch shapes seen so far: the adapter's cache size when it
        exposes one, else the engine's own first-sight bucket count (the
        port's adapters run eagerly and expose none). Bounded by
        ``len(self.buckets)`` for all traffic through this engine."""
        n = self.adapter.cache_size()
        if n is None:
            with self._seen_lock:
                n = len(self._seen_buckets)
        return n

    @property
    def queue_depth_rows(self) -> int:
        return self._admission.depth_rows

    def ledger_stats(self) -> dict:
        """Point-in-time resource accounting for the zero-leak ledger
        (serving/ledger.py): queued rows and the dispatcher's in-flight
        batch — both must read zero once the engine is shut down."""
        with self._wd_lock:
            inflight = sum(r.rows for r in self._inflight)
        return {"name": self.name,
                "queue_depth": self._admission.depth_rows,
                "inflight_rows": inflight}


__all__ = ["InferenceEngine", "bucket_ladder", "RejectedError",
           "QueueFullError", "DeadlineExceededError", "CircuitOpenError",
           "PoisonedResultError", "WatchdogTimeoutError"]
