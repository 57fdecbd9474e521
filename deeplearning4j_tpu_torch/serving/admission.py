"""Admission control for the serving engines (counterpart:
``deeplearning4j_tpu/serving/admission.py``): a bounded request queue
with backpressure, per-request deadlines and typed shedding.

An overloaded server turns unbounded queueing into an immediate typed
rejection the caller can act on (Clipper NSDI'17 §4.3, ORCA OSDI'22 §5):
a full queue rejects at submit, and requests whose deadline passed are
shed at dequeue time without ever occupying a slot. With a
:class:`~deeplearning4j_tpu_torch.serving.qos.QosPolicy` the FIFO becomes
the priority-strict weighted-fair :class:`~deeplearning4j_tpu_torch.
serving.qos.TenantQueues`, with per-tenant quotas metered at admit.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Optional

from deeplearning4j_tpu_torch.serving.tracing import NULL_TRACE

#: The tenant every un-attributed request rides under (shared anonymous
#: bucket). Defined here — next to Request, whose
#: ``tenant`` field defaults to it — and re-exported by serving/qos.py so
#: the literal cannot drift between the dataclass default and resolve_qos.
DEFAULT_TENANT = "anon"


class RejectedError(RuntimeError):
    """Request refused by admission control. ``reason`` is machine-readable:
    'queue_full' | 'deadline' | 'shutdown'."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class QueueFullError(RejectedError):
    """Backpressure rejection. Carries the observed ``depth`` and the
    configured ``capacity`` (in the controller's unit — rows for the batch
    engine, requests for the generation engine) so callers and dashboards
    see HOW full, not just "full"."""

    def __init__(self, msg: str, depth: Optional[int] = None,
                 capacity: Optional[int] = None):
        super().__init__(msg, "queue_full")
        self.depth = depth
        self.capacity = capacity


class DeadlineExceededError(RejectedError):
    def __init__(self, msg: str):
        super().__init__(msg, "deadline")


class QuotaExceededError(RejectedError):
    """Per-tenant rate-quota rejection (reason 'quota_exceeded'): the
    tenant's token bucket (serving/qos.py) is dry. Typed separately from
    queue-full so a flooding tenant's own rejections never read as system
    backpressure. Carries ``tenant`` and the configured ``quota``
    (cost units/second)."""

    def __init__(self, msg: str, tenant: Optional[str] = None,
                 quota: Optional[float] = None):
        super().__init__(msg, "quota_exceeded")
        self.tenant = tenant
        self.quota = quota


class SloShedError(RejectedError):
    """Shed by the SLO-burn governor (reason 'slo_shed'): the rolling SLO
    window is burning past its configured threshold, so deferrable
    (batch-class) traffic sheds at submit until the window clears.
    ``detail`` names the signal that tripped (error rate or p99)."""

    def __init__(self, msg: str, detail: str = ""):
        super().__init__(msg, "slo_shed")
        self.detail = detail


class ClusterCapacityError(RejectedError):
    """The whole fleet is out of capacity (reason 'cluster_capacity'):
    the cluster front door (serving/cluster.py) found live hosts but none
    with admission headroom — the cross-host analogue of queue-full,
    typed separately so "this host is busy" and "the deployment is
    saturated" stay apart. Carries the ``hosts`` joined and ``alive``
    counts at shed time."""

    def __init__(self, msg: str, hosts: Optional[int] = None,
                 alive: Optional[int] = None):
        super().__init__(msg, "cluster_capacity")
        self.hosts = hosts
        self.alive = alive


class HostUnavailableError(RejectedError):
    """No usable host for this request (reason 'host_unavailable'): the
    pinned host is dead or stale past its probe allowance, or every
    candidate is — distinct from cluster_capacity because the cure
    differs (bring hosts back, not add capacity). ``host`` names the
    pinned host when one was, else None."""

    def __init__(self, msg: str, host: Optional[int] = None):
        super().__init__(msg, "host_unavailable")
        self.host = host


class HostDrainingError(RejectedError):
    """The host is draining (reason 'host_draining'): admission is
    closed ahead of a graceful leave — resident streams finish, queued
    work drains, nothing new is accepted. The cluster front door excludes
    draining hosts from its candidates, so this reason only reaches
    callers who submit to the host directly. ``host`` names the draining
    host when known."""

    def __init__(self, msg: str, host: Optional[int] = None):
        super().__init__(msg, "host_draining")
        self.host = host


class RpcError(RejectedError):
    """The RPC data plane could not interpret a peer's wire payload
    (reason 'rpc_error'): malformed JSON, a response missing required
    fields, or a schema the receiver cannot branch on. Distinct from
    'host_unavailable' (the host answered — with garbage); the front door
    still treats it as a host bounce and re-dispatches. ``host`` names
    the peer whose payload failed to parse."""

    def __init__(self, msg: str, host: Optional[int] = None):
        super().__init__(msg, "rpc_error")
        self.host = host


class KVBlocksExhaustedError(RejectedError):
    """The paged KV-cache block pool cannot serve this request (reason
    'kv_blocks_exhausted'): its worst-case block reservation exceeds what
    the pool can EVER free (capacity minus pinned shared-prefix blocks).
    Transient pressure — enough usable blocks, just currently held by
    live streams — is NOT this error: those requests wait in queue and
    ride the normal deadline/queue-full backpressure. Carries ``needed``
    / ``usable`` / ``capacity`` (in blocks) so callers and dashboards see
    how far over budget the request was."""

    def __init__(self, msg: str, needed: Optional[int] = None,
                 usable: Optional[int] = None,
                 capacity: Optional[int] = None):
        super().__init__(msg, "kv_blocks_exhausted")
        self.needed = needed
        self.usable = usable
        self.capacity = capacity


class PreemptedError(RejectedError):
    """A resident generation stream was evicted to reclaim KV blocks
    (reason 'preempted') and could NOT be resumed: either admission
    closed before the recompute requeue landed, or the stream's resume
    footprint can no longer ever fit the pool (its blocks were freed;
    shared-prefix pins grew underneath it). Ordinarily preemption is
    invisible to the caller — the victim requeues through the prefill
    path with its generated-so-far tokens appended to the prompt (or,
    above the engine's ``swap_threshold_blocks`` crossover, its KV
    blocks ride host RAM and are copied straight back in, skipping the
    recompute prefill entirely) and the resumed stream is
    bitwise-identical to an unpreempted run — so this terminal only
    surfaces when the resume is impossible. Distinct from
    'kv_blocks_exhausted': tokens were already delivered, and the cure
    is resubmitting the whole request (elsewhere), not shrinking it.
    Carries the count of ``tokens_generated`` before eviction."""

    def __init__(self, msg: str, tokens_generated: Optional[int] = None):
        super().__init__(msg, "preempted")
        self.tokens_generated = tokens_generated


@dataclass
class Request:
    """One submitted inference request (``rows`` leading-dim rows of x)."""

    x: object                      # the engine's payload: batch-major rows
    #                                (InferenceEngine) or a GenerationRequest
    rows: int
    future: Future = field(default_factory=Future)
    submit_t: float = field(default_factory=time.perf_counter)
    deadline_t: Optional[float] = None   # perf_counter timestamp, or None
    # request-scoped trace (serving/tracing.py). NULL_TRACE is the shared
    # no-op singleton, so un-sampled requests pay nothing here
    trace: object = NULL_TRACE
    # ---- multi-tenant QoS identity (serving/qos.py) ----------------------
    # every request belongs to a tenant and a priority class; without a
    # QosPolicy these are pure accounting labels (the shared anonymous
    # tenant, interactive class) and never affect ordering
    tenant: str = DEFAULT_TENANT
    priority: str = "interactive"
    # weighted-fair-queueing tags, stamped by TenantQueues.append when a
    # policy is active (virtual start/finish times + arrival tiebreak)
    qos_start_tag: float = 0.0
    qos_finish_tag: float = 0.0
    qos_seq: int = 0

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_t is None:
            return False
        return (now if now is not None else time.perf_counter()) >= self.deadline_t


class AdmissionController:
    """Bounded FIFO of :class:`Request` measured in ROWS (the unit devices
    care about), with condition-variable handoff to the dispatcher.

    - ``admit()`` raises :class:`QueueFullError` when capacity_rows would be
      exceeded — backpressure is synchronous and immediate.
    - ``take(max_rows, timeout)`` pops the head if it fits the remaining
      batch budget; expired heads are shed (future completed with
      :class:`DeadlineExceededError`) without consuming budget.
    - ``close()`` wakes the dispatcher and rejects everything still queued.
    """

    def __init__(self, capacity_rows: int = 1024,
                 default_timeout_ms: Optional[float] = None,
                 unit: str = "rows", policy=None):
        if capacity_rows <= 0:
            raise ValueError("capacity_rows must be positive")
        self.capacity_rows = capacity_rows
        self.default_timeout_ms = default_timeout_ms
        self.unit = unit  # the cost unit of capacity and quotas
        # qos.QosPolicy swaps the single FIFO for the priority-strict
        # weighted-fair TenantQueues (deque-shaped, so take/close/requeue
        # below are queue-kind-agnostic) and adds per-tenant quota
        # metering at admit. policy=None keeps the plain deque — the
        # bitwise-identical pre-QoS path.
        self.policy = policy
        if policy is not None:
            from deeplearning4j_tpu_torch.serving.qos import TenantQueues

            self._q = TenantQueues(policy, unit=unit)
        else:
            self._q = deque()
        self._rows = 0
        # latched True by the first deadline-bearing admit: controllers
        # that never see a deadline (no default_timeout_ms, no per-call
        # timeouts) skip expire_queued()'s O(queued) scan entirely — the
        # batch dispatcher runs that sweep every loop turn under this lock
        self._has_deadlines = False
        self._cv = threading.Condition()
        self._closed = False
        self.shed_count = 0
        # observer hooks: called with each shed / close-rejected Request
        # AFTER its future is failed (the engine wires its rejection
        # counters + SLO outcomes here so terminals from every path land
        # in the same metrics). Neither fires for a request whose terminal
        # someone else already delivered.
        self.on_shed: Optional[callable] = None
        self.on_close_reject: Optional[callable] = None
        # a queued future that is already done when we try to fail it can
        # only have been cancelled by the caller (the watchdog only fails
        # in-flight work): this hook records that terminal instead
        self.on_cancelled: Optional[callable] = None

    # ------------------------------------------------------------- metrics
    @property
    def depth_rows(self) -> int:
        with self._cv:
            return self._rows

    @property
    def depth_requests(self) -> int:
        with self._cv:
            return len(self._q)

    def depth_by_tenant(self) -> dict:
        """Queued requests per tenant (QoS multi-queue only; empty dict on
        the FIFO path, where tenancy does not shape the queue)."""
        with self._cv:
            if self.policy is not None:
                return self._q.depth_by_tenant()
            return {}

    # ---------------------------------------------------------- submit side
    def admit(self, req: Request, timeout_ms: Optional[float] = None) -> Request:
        """Enqueue or raise. ``timeout_ms`` (or the controller default)
        stamps the request deadline relative to now."""
        tmo = timeout_ms if timeout_ms is not None else self.default_timeout_ms
        if tmo is not None:
            req.deadline_t = req.submit_t + tmo / 1000.0
        with self._cv:
            if self._closed:
                raise RejectedError("engine is shut down", "shutdown")
            if req.deadline_t is not None:
                self._has_deadlines = True
            if self.policy is not None:
                # backlog bound before the rate bucket (a depth shed must
                # not also drain quota tokens), quota before capacity: a
                # flooding tenant's excess sheds as ITS quota_exceeded,
                # never as queue_full backpressure on everyone (tokens
                # spent here are not refunded on a later capacity
                # rejection — quota meters offered load)
                self._q.check_depth(req)
                self._q.charge_quota(req)
            if self._rows + req.rows > self.capacity_rows:
                raise QueueFullError(
                    f"queue full: {self._rows} {self.unit} queued + "
                    f"{req.rows} submitted > capacity {self.capacity_rows} "
                    f"{self.unit}", depth=self._rows,
                    capacity=self.capacity_rows)
            self._q.append(req)
            self._rows += req.rows
            depth = self._rows
            self._cv.notify()
        req.trace.event("queue.admit", depth=depth, unit=self.unit)
        return req

    # -------------------------------------------------------- dispatch side
    def _shed(self, req: Request):
        self.shed_count += 1
        waited_ms = (time.perf_counter() - req.submit_t) * 1e3
        req.trace.event("queue.shed", waited_ms=round(waited_ms, 3))
        delivered = True
        try:
            req.future.set_exception(DeadlineExceededError(
                f"deadline exceeded after {waited_ms:.1f} ms in queue"))
        except InvalidStateError:
            # the caller cancelled this future while it was queued — that
            # IS the terminal; record it as such (not as a shed)
            delivered = False
        if not delivered:
            self._cancelled(req)
            return
        if self.on_shed is not None:
            self.on_shed(req)   # engine hook: metrics + trace terminal
        else:
            req.trace.finish("deadline", latency_ms=waited_ms)

    def take(self, max_rows: int, timeout: float) -> Optional[Request]:
        """Pop the head request if it fits in ``max_rows``; block up to
        ``timeout`` seconds for one to arrive. Returns None on timeout, on
        close, or when the head is too large for the remaining budget (the
        dispatcher should then seal the batch and come back).

        Expired heads are unlinked under the lock but their futures are
        failed OUTSIDE it: set_exception runs done-callbacks synchronously,
        and a callback that re-enters the controller (retry-on-shed) would
        deadlock on the non-reentrant condition lock (close() orders its
        rejections the same way)."""
        end = time.perf_counter() + timeout
        while True:
            shed, out, decided = [], None, False
            with self._cv:
                while True:
                    if self._q:
                        head = self._q[0]
                        if head.expired():
                            self._q.popleft()
                            if self.policy is not None:
                                # shed, not served: no WFQ service debt
                                self._q.forget_unserved(head)
                            self._rows -= head.rows
                            shed.append(head)
                            continue
                        decided = True
                        if head.rows <= max_rows:
                            self._q.popleft()
                            self._rows -= head.rows
                            out = head
                        break
                    remaining = end - time.perf_counter()
                    if self._closed or remaining <= 0:
                        decided = True
                        break
                    if shed:
                        break  # drop the lock to fail shed futures first
                    self._cv.wait(remaining)
            for req in shed:
                self._shed(req)
            if decided:
                return out

    def requeue_head(self, req: Request):
        """Return a just-dequeued request to the queue HEAD. The paged
        generation scheduler pops the head to inspect its block demand and
        puts it back when the pool cannot serve it *yet* (free blocks will
        reappear as live streams retire) — on the FIFO path order is
        preserved because there is exactly one consumer; under a
        QosPolicy a higher-priority/lower-tag request MAY be selected
        ahead of the returned head (by design — the generation engine's
        block-waiter reservation keeps such overtakers from starving
        it). If the controller closed in
        between, the request is rejected the same way ``close()`` rejects
        queued work (failing outside the lock, as everywhere)."""
        rejected = False
        with self._cv:
            if self._closed:
                rejected = True
            else:
                self._q.appendleft(req)
                self._rows += req.rows
                self._cv.notify()
        if not rejected:
            return
        try:
            req.future.set_exception(
                RejectedError("engine shut down with request queued",
                              "shutdown"))
        except InvalidStateError:
            self._cancelled(req)
            return
        if self.on_close_reject is not None:
            self.on_close_reject(req)
        else:
            req.trace.finish("shutdown")

    def expire_queued(self) -> int:
        """Proactively shed every expired request still queued, returning
        the number shed. The batching dispatcher sheds lazily (expired
        heads drop at ``take()``), which is fine when dequeue is frequent —
        but a slot-bound scheduler (continuous-batching decode) only calls
        ``take()`` when a cache slot is FREE, so under full occupancy a
        dead prompt would sit in the queue holding capacity_rows budget and
        masking the queue-full backpressure signal. The generation loop
        calls this once per iteration; futures fail outside the lock for
        the same retry-on-shed reentrancy reason as ``take()``."""
        now = time.perf_counter()
        shed = []
        with self._cv:
            if not self._has_deadlines:
                return 0   # nothing queued can ever expire: O(1) out
            if self.policy is not None:
                shed = self._q.remove_expired(now)
                if shed:
                    self._rows -= sum(r.rows for r in shed)
            elif any(r.expired(now) for r in self._q):
                keep: deque = deque()
                for req in self._q:
                    (shed if req.expired(now) else keep).append(req)
                self._q = keep
                self._rows = sum(r.rows for r in keep)
        for req in shed:
            self._shed(req)
        return len(shed)

    def close(self):
        with self._cv:
            self._closed = True
            pending = list(self._q)
            self._q.clear()
            self._rows = 0
            self._cv.notify_all()
        for req in pending:
            try:
                req.future.set_exception(
                    RejectedError("engine shut down with request queued",
                                  "shutdown"))
            except InvalidStateError:
                self._cancelled(req)   # caller-cancelled while queued
                continue
            if self.on_close_reject is not None:
                self.on_close_reject(req)
            else:
                req.trace.finish("shutdown")

    def _cancelled(self, req: Request):
        if self.on_cancelled is not None:
            self.on_cancelled(req)
        else:
            req.trace.finish("cancelled")
