"""Resilience primitives for the serving engine (counterpart:
``deeplearning4j_tpu/serving/resilience.py``): bounded retry, circuit
breaking and a scheduler watchdog.

The engine fails per iteration rather than per process (ORCA OSDI'22), so
every fault lands in one of three regimes, each with its own primitive:

- **transient** (one prefill, decode or verify call fails but the next
  would succeed): :class:`RetryPolicy` — bounded attempts with
  exponential backoff and seeded jitter. Only failures tagged
  ``transient`` that raised BEFORE the step launched anything are
  retried (:func:`is_transient`); a retry re-runs the same kernels.
- **persistent** (every call fails): :class:`CircuitBreaker` — CLOSED ->
  OPEN after a consecutive-failure threshold, typed
  :class:`CircuitOpenError` sheds at submit while OPEN, one HALF_OPEN
  probe after the cooldown.
- **wedged** (the scheduler thread stops heartbeating): :class:`Watchdog`
  — a monitor thread that, when the heartbeat is stale while work is
  outstanding, fails the in-flight streams with a typed
  :class:`WatchdogTimeoutError` and calls the engine's recovery hook
  (epoch bump, a NEW KV pool, a fresh scheduler thread). The wedged thread
  becomes an epoch-stale zombie whose late effects the engine drops.
  On a GPU the watchdog covers host stalls only: a thread blocked inside
  a CUDA call on a hung kernel cannot be replaced, because the new
  thread's launches queue behind it on the same stream.

All three surface in ``ServingMetrics`` (retries, breaker transitions,
watchdog restarts).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.admission import RejectedError


class CircuitOpenError(RejectedError):
    """Shed because the deployment's breaker is OPEN (reason
    'circuit_open') — the typed fast-fail callers route around."""

    def __init__(self, msg: str):
        super().__init__(msg, "circuit_open")


class WatchdogTimeoutError(RejectedError):
    """In-flight request failed by the dispatcher watchdog (reason
    'watchdog'): the engine loop stopped heartbeating and was restarted."""

    def __init__(self, msg: str):
        super().__init__(msg, "watchdog")


class PoisonedResultError(RejectedError):
    """A dispatch/decode produced a poisoned result — non-finite values
    (NaN/inf) or out-of-vocab token ids — caught by the engines' output
    screen before any caller saw it (reason 'poisoned'). A RejectedError
    subclass on purpose: typed for callers, counted in
    ``rejections_by_reason``, and NOT crash-dumped (the flight recorder
    carries the forensics; a sick replica screening every batch must not
    litter the workspace). It still counts as a dispatch failure, so a
    persistently-poisoned deployment trips its circuit breaker and is
    quarantined."""

    def __init__(self, msg: str):
        super().__init__(msg, "poisoned")


class RetryBudgetExhaustedError(RejectedError):
    """A transient failure would have been retried, but the deployment's
    retry budget (:class:`RetryBudget`) is spent — the request fails
    typed (reason 'retry_budget_exhausted') instead, so a retry storm
    cannot amplify a brown-out. The original transient failure rides as
    ``__cause__``."""

    def __init__(self, msg: str):
        super().__init__(msg, "retry_budget_exhausted")


class RetryBudget:
    """Google-SRE-style retry budget: a per-deployment token bucket where
    every INCOMING request deposits ``ratio`` tokens (capped at ``burst``,
    which it starts holding) and every retry spends one.

    The invariant this buys (SRE book ch. 22, "Handling Overload"): with
    ratio r, sustained retry traffic is at most r× the request traffic —
    so when a deployment browns out and every call starts failing
    transiently, total load is bounded by (1 + r)× offered load instead
    of max_attempts×. When the bucket is dry, the retry layer fails the
    request typed (:class:`RetryBudgetExhaustedError`) rather than
    re-dispatching; healthy-path retries (occasional, paid for by the
    steady deposit stream) are untouched. Shared by every engine over one
    deployment (pass one instance to every engine of it),
    so storms are bounded per deployment, not per engine."""

    def __init__(self, ratio: float = 0.1, burst: float = 10.0):
        if ratio < 0:
            raise ValueError(f"ratio must be >= 0, got {ratio}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._lock = threading.Lock()
        self.spent_total = 0
        self.exhausted_total = 0

    def on_request(self):
        """One incoming request earns the deployment ``ratio`` retries."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        """Take one retry token; False (and counted) when dry."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent_total += 1
                return True
            self.exhausted_total += 1
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def stats(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 3), "burst": self.burst,
                    "ratio": self.ratio, "spent_total": self.spent_total,
                    "exhausted_total": self.exhausted_total}


def is_transient(exc: BaseException) -> bool:
    """Default retry classifier: an exception is retry-worthy iff it says
    so (``transient=True`` attribute — FaultInjectedError and any backend
    error a caller tags) AND it did not escape an already-executing
    donated call (``donated_state_consumed=True``, stamped by the
    generation engine): once a donated prefill/decode has dispatched, its
    cache buffers may be consumed, so re-invoking would use-after-donate —
    that failure must take the fail-tenants-and-rebuild path instead.
    Deterministic model errors (bad input, shape mismatch) must NOT be
    retried either: they re-fail and burn the latency budget of every
    co-batched tenant."""
    return bool(getattr(exc, "transient", False)) \
        and not getattr(exc, "donated_state_consumed", False)


class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter.

    ``max_attempts`` counts the first try; backoff before attempt k is
    ``base_delay_ms * 2^(k-1)``, capped at ``max_delay_ms``, scaled by a
    deterministic jitter in [1, 1+jitter) drawn from a seeded PRNG —
    chaos tests replay the exact same sleep schedule."""

    def __init__(self, max_attempts: int = 3, base_delay_ms: float = 1.0,
                 max_delay_ms: float = 50.0, jitter: float = 0.5,
                 classify: Callable[[BaseException], bool] = is_transient,
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay_ms = base_delay_ms
        self.max_delay_ms = max_delay_ms
        self.jitter = jitter
        self.classify = classify
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def backoff_ms(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based)."""
        base = min(self.base_delay_ms * (2.0 ** (attempt - 1)),
                   self.max_delay_ms)
        with self._lock:
            u = float(self._rng.random())
        return base * (1.0 + self.jitter * u)

    def call(self, fn: Callable[[], object],
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             budget: Optional[RetryBudget] = None):
        """Run ``fn`` with retries. ``on_retry(attempt, exc)`` fires before
        each backoff sleep (the engines count retries there). The final
        failure — non-transient, or attempts exhausted — propagates.
        ``budget`` (a :class:`RetryBudget`) is consulted before EACH
        retry: a dry budget converts the would-be retry into a typed
        :class:`RetryBudgetExhaustedError` (original failure chained), so
        storms stop amplifying at the deployment's configured ratio."""
        attempt = 1
        while True:
            try:
                return fn()
            except BaseException as e:
                if attempt >= self.max_attempts or not self.classify(e):
                    raise
                if budget is not None and not budget.try_spend():
                    raise RetryBudgetExhaustedError(
                        f"retry budget exhausted (ratio {budget.ratio:g}, "
                        f"burst {budget.burst:g}): failing typed instead "
                        f"of retrying {type(e).__name__} (attempt "
                        f"{attempt}/{self.max_attempts})") from e
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(self.backoff_ms(attempt) / 1e3)
                attempt += 1


class CircuitBreaker:
    """Per-deployment breaker: CLOSED -> OPEN after ``failure_threshold``
    CONSECUTIVE failures; while OPEN, :meth:`allow` returns False (the
    engine sheds with :class:`CircuitOpenError`) until ``cooldown_s``
    elapses, then exactly ONE caller gets a HALF_OPEN probe; the probe's
    outcome closes the breaker or re-opens it for another cooldown.

    Thread-safe; transition listeners (``add_listener``) receive
    ``(old_state, new_state)`` and feed ServingMetrics.
    """

    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 5.0,
                 name: str = "", clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self._clock = clock
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self._listeners: List[Callable[[str, str], None]] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- listeners
    def add_listener(self, fn: Callable[[str, str], None]) -> "CircuitBreaker":
        with self._lock:
            self._listeners.append(fn)
        return self

    def remove_listener(self, fn: Callable[[str, str], None]):
        """Engines sharing a deployment breaker detach their metrics
        listener on shutdown — otherwise a long-lived deployment spinning up
        engines leaks one listener (and double-counts transitions) per
        dead engine."""
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _transition(self, new: str):
        """Caller holds the lock. Listener callbacks run outside it."""
        old, self._state = self._state, new
        return old

    def _notify(self, old: str, new: str):
        for fn in list(self._listeners):
            try:
                fn(old, new)
            except Exception:
                pass  # a broken listener must not poison the breaker

    # ---------------------------------------------------------------- state
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def allow(self) -> bool:
        """Admission-time gate. CLOSED: always. OPEN: False until the
        cooldown expires, then the first caller flips to HALF_OPEN and is
        the probe. HALF_OPEN: only while no probe is outstanding — but a
        probe older than another full cooldown is treated as LOST (the
        probe request can die before ever reaching dispatch: shed on
        deadline, queue-full, caller cancel — none of which report back)
        and its permit is re-granted, so the breaker cannot wedge in
        HALF_OPEN forever."""
        notify = None
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                notify = (self._transition(self.HALF_OPEN), self.HALF_OPEN)
                self._probe_inflight = True
                self._probe_started = now
                ok = True
            else:  # HALF_OPEN
                if self._probe_inflight and \
                        now - self._probe_started >= self.cooldown_s:
                    self._probe_inflight = False   # lost probe: re-grant
                ok = not self._probe_inflight
                if ok:
                    self._probe_inflight = True
                    self._probe_started = now
        if notify is not None:
            self._notify(*notify)
        return ok

    def record_success(self):
        notify = None
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            if self._state != self.CLOSED:
                notify = (self._transition(self.CLOSED), self.CLOSED)
        if notify is not None:
            self._notify(*notify)

    def record_failure(self):
        notify = None
        with self._lock:
            self._consecutive += 1
            self._probe_inflight = False
            if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._opened_at = self._clock()
                notify = (self._transition(self.OPEN), self.OPEN)
            elif self._state == self.OPEN:
                # a straggler failure while already OPEN re-arms the
                # cooldown but is not a new transition
                self._opened_at = self._clock()
        if notify is not None:
            self._notify(*notify)


class Watchdog:
    """Heartbeat monitor for an engine's dispatcher/scheduler thread.

    The monitored loop calls :meth:`beat` once per iteration; the watchdog
    thread wakes every ``interval_s`` and, when the heartbeat is older
    than ``timeout_s`` AND ``busy()`` reports outstanding work, declares
    the loop wedged and invokes ``on_stall()`` (the engine's recovery
    hook: fail in-flight futures typed, bump the epoch so the zombie's
    late effects are suppressed, rebuild donated state, start a fresh
    thread). An idle loop blocked on an empty queue heartbeats on every
    poll timeout and never trips.

    Size ``timeout_s`` at N× the engine's deadline/worst dispatch (first
    compiles included, or warm the engine first) — a false trip costs the
    in-flight batch."""

    def __init__(self, *, timeout_s: float, busy: Callable[[], bool],
                 on_stall: Callable[[], None], name: str = "engine",
                 interval_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError("timeout_s must be positive")
        self.timeout_s = timeout_s
        self._busy = busy
        self._on_stall = on_stall
        self._interval = interval_s if interval_s is not None else max(
            timeout_s / 4.0, 0.01)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.restarts = 0
        self._thread = threading.Thread(
            target=self._loop, name=f"serving-watchdog[{name}]", daemon=True)

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _loop(self):
        while not self._stop.wait(self._interval):
            if time.monotonic() - self._last <= self.timeout_s:
                continue
            if not self._busy():
                self.beat()  # idle staleness is not a stall
                continue
            self.restarts += 1
            try:
                self._on_stall()
            except Exception:
                pass  # recovery failure must not kill the monitor itself
            self.beat()


class ResilientEngineMixin:
    """The resilience and observability scaffolding a serving engine
    carries, with engine-specific hooks.

    The host class must provide, before calling :meth:`_init_resilience`:
    ``self.name`` and ``self.metrics``; and must implement the watchdog
    hooks ``_watchdog_busy()`` / ``_watchdog_stall()`` (busy/stall
    behavior is the part that genuinely differs between a batch
    dispatcher and an iteration scheduler). Optional hooks:

    - ``_retry_traces()`` — traces to stamp ``retry.attempt`` events on
      (the in-flight batch / the in-prefill request / the live slots).
    - ``_crash_dump_model()`` / ``_crash_dump_context()`` — what the
      crash dump describes.
    """

    _COMPONENT = "serving.Engine"
    _FAILURE_NOUN = "dispatch"   # breaker shed message wording

    def _init_resilience(self, *, retry_policy: Optional[RetryPolicy] = None,
                         breaker: Optional[CircuitBreaker] = None,
                         retry_budget: Optional[RetryBudget] = None,
                         tracer=None, recorder=None):
        from deeplearning4j_tpu_torch.serving.tracing import (
            default_tracer, flight_recorder)

        self._tracer = tracer if tracer is not None else default_tracer()
        self._recorder = recorder if recorder is not None \
            else flight_recorder()
        # default RetryPolicy retries only transient-tagged failures, so a
        # deterministic model error still fails fast; default breaker opens
        # after 5 consecutive failures. Pass explicit instances to share a
        # breaker across engines of one deployment or
        # to disable retries (max_attempts=1).
        self._retry = retry_policy if retry_policy is not None \
            else RetryPolicy()
        # retry budget: None (default) = unmetered retries, today's
        # behavior; share one per deployment so storms are
        # bounded deployment-wide (see RetryBudget design notes)
        self._retry_budget = retry_budget
        self._breaker = breaker if breaker is not None \
            else CircuitBreaker(name=self.name)
        self._breaker.add_listener(self.metrics.record_breaker_transition)
        self._breaker.add_listener(self._flight_breaker)
        self._epoch = 0          # bumped by the watchdog; stales zombies
        self._wd_lock = threading.Lock()
        self._crash_dumped = False
        self._watchdog: Optional[Watchdog] = None

    def _shutdown_resilience(self):
        """Teardown half: stop the watchdog (no restarts mid-shutdown) and
        detach our listeners from the breaker — it may outlive this engine
        (shared per deployment) and dead engines must not accumulate."""
        if self._watchdog is not None:
            self._watchdog.stop()
        self._breaker.remove_listener(self.metrics.record_breaker_transition)
        self._breaker.remove_listener(self._flight_breaker)

    # ------------------------------------------------------------- breaker
    def _flight_breaker(self, old: str, new: str):
        self._recorder.record("breaker.transition", engine=self.name,
                              old=old, new=new)

    def _breaker_gate(self, trace, tenant: Optional[str] = None):
        """Submit-time shed while the breaker is OPEN: typed, counted,
        traced."""
        if self._breaker.allow():
            return
        self.metrics.rejected_total.inc()
        self.metrics.rejected_circuit_open.inc()
        self.metrics.record_rejection("circuit_open")
        self._finish_request(trace, "circuit_open", tenant=tenant)
        raise CircuitOpenError(
            f"circuit open for engine[{self.name}] after "
            f"{self._breaker.consecutive_failures} consecutive "
            f"{self._FAILURE_NOUN} failures; retry after the cooldown")

    # ------------------------------------------------------------ terminals
    def _finish_request(self, trace, reason: str,
                        latency_ms: Optional[float] = None,
                        tenant: Optional[str] = None):
        """One request reached a terminal state: close its trace (tail
        sampling decides retention) and feed the SLO windows — the same
        reason string both places, and the same string
        ``record_rejection`` used for this cause, so the SLO error
        buckets match ``rejections_by_reason`` keys exactly. ``tenant``
        additionally attributes the outcome to the per-tenant QoS
        counters (served/shed + per-tenant rejection reasons) — every
        call site that holds the Request passes its tenant."""
        self.metrics.record_outcome(reason, latency_ms)
        if tenant is not None:
            self.metrics.record_tenant_outcome(tenant, reason)
        trace.finish(reason, latency_ms=latency_ms)

    def _count_request(self):
        """One request entered submit(): the QPS counter plus the retry
        budget's deposit (incoming traffic is what EARNS retries — the
        Google SRE ratio invariant)."""
        self.metrics.requests_total.inc()
        if self._retry_budget is not None:
            self._retry_budget.on_request()

    def _count_shed(self, req):
        """AdmissionController.on_shed hook: a queued request expired."""
        self.metrics.rejected_total.inc()
        self.metrics.rejected_deadline.inc()
        self.metrics.record_rejection("deadline")
        self._finish_request(req.trace, "deadline", tenant=req.tenant)

    def _count_close_reject(self, req):
        """AdmissionController.on_close_reject hook: a queued request was
        rejected by shutdown — same accounting as the engine's post-close
        drain, so a shutdown terminal reaches the SLO windows and
        ``rejections_by_reason`` no matter which path rejected it."""
        self.metrics.record_rejection("shutdown")
        self._finish_request(req.trace, "shutdown", tenant=req.tenant)

    def _count_cancelled(self, req):
        """AdmissionController.on_cancelled hook: a caller cancelled a
        queued future — recorded with the same 'cancelled' outcome the
        dispatch-time cancel path uses, whichever thread observes it."""
        self._finish_request(req.trace, "cancelled", tenant=req.tenant)

    def _reject_submit(self, trace, exc: RejectedError,
                       tenant: Optional[str] = None):
        """Shared accounting for a submit-time admission rejection."""
        self.metrics.rejected_total.inc()
        reason = getattr(exc, "reason", None)
        if reason == "queue_full":
            self.metrics.rejected_queue_full.inc()
        elif reason == "quota_exceeded":
            self.metrics.quota_rejections_total.inc()
        elif reason == "slo_shed":
            self.metrics.slo_sheds_total.inc()
        self.metrics.record_rejection(exc.reason)
        self._finish_request(trace, exc.reason, tenant=tenant)

    def _shed_typed(self, req, exc: RejectedError):
        """Fail an already-DEQUEUED request with a typed serving error —
        the scheduler-side shed path (e.g. a paged-KV request whose block
        demand can never be satisfied). Mirrors the submit-time
        accounting: rejection counters + SLO terminal + trace, all keyed
        by ``exc.reason``; a future the caller cancelled first records
        'cancelled' instead, exactly once either way."""
        from concurrent.futures import InvalidStateError

        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            self._finish_request(req.trace, "cancelled", tenant=req.tenant)
            return
        self.metrics.rejected_total.inc()
        self.metrics.record_rejection(exc.reason)
        self._recorder.record("request.shed", engine=self.name,
                              reason=exc.reason)
        self._finish_request(req.trace, exc.reason, tenant=req.tenant)

    # -------------------------------------------------------------- retries
    def _retry_call(self, fn: Callable[[], object]):
        """THE retry entry the engine routes device calls through:
        bounded retry (RetryPolicy) gated by the deployment's retry
        budget. A dry budget fails the call typed — counted here so
        'retry_budget_exhausted' lands in ``rejections_by_reason`` beside
        every other shed cause before the engine's normal failure tail
        (breaker, tenants failed typed, SLO terminal) takes over."""
        try:
            return self._retry.call(fn, on_retry=self._on_retry,
                                    budget=self._retry_budget)
        except RetryBudgetExhaustedError:
            self.metrics.retry_budget_exhausted_total.inc()
            self.metrics.record_rejection("retry_budget_exhausted")
            self._recorder.record("retry_budget.exhausted",
                                  engine=self.name)
            raise

    def _on_retry(self, attempt: int, exc: BaseException):
        self.metrics.retries_total.inc()
        if getattr(exc, "injected", False):
            self.metrics.faults_injected_total.inc()
        self._recorder.record("retry", engine=self.name, attempt=attempt,
                              error=type(exc).__name__)
        for tr in self._retry_traces():
            tr.event("retry.attempt", attempt=attempt,
                     error=type(exc).__name__)

    def _retry_traces(self):
        return ()

    # ---------------------------------------------------- poisoned results
    def _poisoned(self, point: str, detail: str):
        """A dispatch/decode output failed the NaN/inf/vocab screen: count
        it, flight-record it, and fail the batch typed. Raised inside the
        dispatch try-block, so the normal failure tail applies — breaker
        failure, tenants failed typed — while the RejectedError lineage
        keeps crash dumps quiet."""
        self.metrics.poisoned_results_total.inc()
        self.metrics.record_rejection("poisoned")
        self._recorder.record("poisoned_result", engine=self.name,
                              point=point, detail=detail)
        raise PoisonedResultError(
            f"poisoned result from {point} on engine[{self.name}]: {detail} "
            f"— batch failed before delivery; the deployment breaker "
            f"records the failure")

    def _screen_finite(self, y, point: str):
        """Cheap poisoned-result guard: NaN or +inf in an inexact-dtype
        output fails the batch typed. ``-inf`` is deliberately allowed —
        masked logits and log-probabilities of impossible classes are
        legitimately ``-inf``, and screening them would quarantine healthy
        models. Two cheap reductions over a host array the dispatcher
        already holds — noise next to the device call it follows."""
        arr = np.asarray(y)
        if not np.issubdtype(arr.dtype, np.inexact):
            return
        n_nan = int(np.count_nonzero(np.isnan(arr)))
        n_pinf = int(np.count_nonzero(np.isposinf(arr)))
        if n_nan or n_pinf:
            self._poisoned(
                point, f"{n_nan} NaN + {n_pinf} +inf values in "
                       f"{arr.size}-element output")

    # ------------------------------------------------------------ forensics
    def _maybe_crash_dump(self, exc: BaseException, **context):
        """Serving crashes get the training path's forensics: the FIRST
        non-injected unexpected failure writes a memory crash dump
        (util/crash_reporting — which appends the flight-recorder
        snapshot). Injected chaos faults and typed serving errors
        (RejectedError lineage, poisoned screens included) never dump, and
        the dump itself can never mask the original error."""
        if getattr(exc, "injected", False):
            self.metrics.faults_injected_total.inc()
            return
        if self._crash_dumped or isinstance(exc, RejectedError):
            return
        self._crash_dumped = True
        self._recorder.record("crash_dump", engine=self.name,
                              error=type(exc).__name__)
        from deeplearning4j_tpu_torch.util.crash_reporting import (
            writeMemoryCrashDump)
        writeMemoryCrashDump(
            self._crash_dump_model(), exc,
            context={"component": self._COMPONENT, "engine": self.name,
                     **self._crash_dump_context(), **context},
            device=getattr(self, "device", None))

    def _crash_dump_model(self):
        return None

    def _crash_dump_context(self) -> dict:
        return {}

    # ------------------------------------------------------------- watchdog
    def arm_watchdog(self, timeout_ms: float):
        """Arm (or re-arm) the loop watchdog: a dispatcher/scheduler that
        stops heartbeating for ``timeout_ms`` with work outstanding is
        declared wedged — in-flight work fails typed and a fresh thread
        takes over (the engine's ``_watchdog_stall``). Size the timeout at
        N× the engine's deadline and arm AFTER warmup: a first-compile
        pause reads exactly like a stall."""
        if self._watchdog is not None:
            self._watchdog.stop()
        self._watchdog = Watchdog(
            timeout_s=timeout_ms / 1e3,
            busy=self._watchdog_busy, on_stall=self._watchdog_stall,
            name=self.name).start()
        return self

    # ----------------------------------------------------------------- drain
    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """Nothing queued and nothing in flight — the drain's exit
        condition (exactly the watchdog's not-busy predicate)."""
        return not self._watchdog_busy()

    def _drain_wait(self, timeout: Optional[float]) -> bool:
        """The host-leave drain protocol: flip
        the draining flag — new submits shed typed ``host_draining`` —
        then wait for every queued and in-flight request to finish.
        Returns True when fully drained within ``timeout`` (None = wait
        forever); on timeout the engine STAYS draining (admission stays
        closed) so the caller can retry or force ``shutdown()``. One
        copy for both engines — only the post-drain tail (generation's
        prefix-pin release) differs."""
        self._draining = True
        self._recorder.record("engine.drain", engine=self.name)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while not self.drained:
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    @property
    def watchdog_restarts(self) -> int:
        return self._watchdog.restarts if self._watchdog is not None else 0


__all__ = ["RetryPolicy", "RetryBudget", "RetryBudgetExhaustedError",
           "CircuitBreaker", "Watchdog", "CircuitOpenError",
           "WatchdogTimeoutError", "PoisonedResultError",
           "ResilientEngineMixin", "is_transient"]
