"""Multi-tenant quality of service for the serving engine (counterpart:
``deeplearning4j_tpu/serving/qos.py``): weighted-fair queueing with
priority classes, per-tenant rate quotas and queue bounds, SLO-burn-aware
admission, and the speculative decoding acceptance governor.

- **Priority classes + weighted-fair queueing** (:class:`TenantQueues`):
  ``interactive`` strictly precedes ``batch``, and within a class tenants
  share capacity in proportion to their weights by start-time fair
  queueing (Goyal et al., SIGCOMM'96): each request gets virtual
  start/finish tags (``finish = start + cost/weight``) and the dequeue
  picks the smallest finish tag in the highest non-empty class. FIFO per
  tenant; one tenant alone is exact FIFO.
- **Per-tenant quotas** (:class:`TokenBucket`, ``TenantPolicy.quota`` and
  ``max_queued``): excess sheds typed ``quota_exceeded`` at submit,
  before it takes queue capacity, so one tenant's flood cannot turn into
  queue-full rejections for everyone else.
- **SLO-burn-aware shedding** (:class:`SloBurnGovernor`): when the
  configured rolling window's burn error rate (over :data:`BURN_REASONS`)
  or p99 crosses its threshold, ``batch``-class traffic sheds typed
  ``slo_shed`` at submit until the window clears. The governor's own
  sheds do not count toward the burn, so the loop clears by itself.
- **Preemption exemption** (``TenantPolicy.preemptible=False``): the
  on-demand allocator never picks the tenant's streams as another
  stream's victim.

**No policy, no change**: ``qos=None`` (the default) keeps the plain FIFO
deque; requests still carry the anonymous tenant for accounting. The
retry budget (:class:`~deeplearning4j_tpu_torch.serving.resilience.
RetryBudget`) is the other half: budgets gate retries, this module gates
admission; both shed into one terminal-reason taxonomy.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from deeplearning4j_tpu_torch.serving.admission import (
    DEFAULT_TENANT, QuotaExceededError, Request, SloShedError,
)

#: Strict-priority classes, highest first. ``interactive`` traffic always
#: dequeues before ``batch`` regardless of weights; weights arbitrate
#: WITHIN a class.
PRIORITIES = ("interactive", "batch")

#: Terminal reasons that count as the SLO *burning* — failures the tenants
#: suffered, not protective sheds the stack chose. The governor's own
#: ``slo_shed`` (and quota/queue-full rejections) are deliberately absent:
#: counting them would make shedding sustain the very signal that
#: triggered it, and the governor would latch shut.
BURN_REASONS = frozenset({
    "model_error", "watchdog", "poisoned", "deadline",
    "retry_budget_exhausted", "circuit_open",
})


class TokenBucket:
    """Thread-safe token bucket: ``rate`` tokens/second sustained,
    ``burst`` deep (starts full). ``try_take(n)`` is the whole API —
    refill is computed lazily from the injected ``clock`` so tests drive
    it with a fake clock instead of sleeping."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        if burst <= 0:
            raise ValueError(f"burst must be positive, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float):
        if now > self._last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's QoS contract. ``weight`` is its share within its
    priority class (relative to the other tenants of that class);
    ``quota`` is its sustained admission rate in the controller's cost
    unit per second (rows for the batch engine, requests for generation;
    None = unmetered) with ``quota_burst`` of instantaneous depth
    (defaults to ``max(quota, 1)``)."""

    weight: float = 1.0
    priority: str = "interactive"
    quota: Optional[float] = None
    quota_burst: Optional[float] = None
    # per-tenant queue-depth bound: at most this many cost
    # units of THIS tenant's work queued at once (rows for the batch
    # engine, requests for generation; None = unbounded). Quotas meter
    # the tenant's RATE; max_queued bounds its standing BACKLOG — without
    # it, capacity is global and entry to a starved queue is still a
    # race: a slow-drained tenant can hold arbitrarily much of
    # capacity_rows while WFQ only arbitrates what is already queued.
    # Excess sheds typed 'quota_exceeded' at admit.
    max_queued: Optional[int] = None
    # whether this tenant's RESIDENT generation streams may be evicted by
    # the on-demand KV allocator's preemption (allocate="on_demand",
    # serving/generation.py): preemption already respects strict priority
    # (a stream never evicts a higher class), and within that order
    # preemptible=False exempts a tenant entirely — for workloads whose
    # recompute-on-resume cost is unacceptable (very long generations,
    # per-token billing). A stream may still preempt ITSELF when the pool
    # cannot serve its next block any other way; this flag only shields
    # the tenant from being chosen as someone else's victim.
    preemptible: bool = True

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be positive, got {self.weight}")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got "
                f"{self.priority!r}")
        if self.quota is not None and self.quota <= 0:
            raise ValueError(f"quota must be positive, got {self.quota}")
        if self.quota_burst is not None and self.quota_burst <= 0:
            raise ValueError(
                f"quota_burst must be positive, got {self.quota_burst}")
        if self.max_queued is not None and self.max_queued <= 0:
            raise ValueError(
                f"max_queued must be positive, got {self.max_queued}")


class QosPolicy:
    """The deploy-time QoS contract one engine enforces: per-tenant
    weights / priority classes / quotas, plus the SLO-burn thresholds
    that close the rolling SLO windows' feedback loop.

    - ``tenants`` maps tenant id -> :class:`TenantPolicy` (or a plain
      dict of its fields); unknown tenants get ``default_weight`` /
      ``default_priority`` and no quota.
    - ``slo_shed_error_rate`` / ``slo_shed_p99_ms``: when the
      ``slo_window`` rolling window's burn error rate (over
      :data:`BURN_REASONS`) or success p99 crosses the threshold,
      ``slo_shed_classes`` traffic (default: batch only) sheds typed
      ``slo_shed`` until the window clears. ``slo_min_samples`` keeps a
      near-empty window from tripping the governor on one bad request.
    - ``slo_clear_error_rate`` / ``slo_clear_p99_ms``: HYSTERESIS — the
      governor trips at the shed threshold but only clears once the
      signal falls below the (lower) clear threshold. A window hovering
      around one shared threshold would otherwise flap the batch class
      shed/admit every ``slo_check_interval_s`` (each admit pulse feeds
      new outcomes that push the rate back over, each shed pulse lets
      it decay back under). ``None`` (the default) clears at the trip
      threshold — the pre-hysteresis behavior. A clear threshold
      requires its trip threshold and must not exceed it.
    - ``clock`` feeds the quota buckets (fake-clock testable).
    """

    def __init__(self, tenants: Optional[Dict[str, object]] = None, *,
                 default_weight: float = 1.0,
                 default_priority: str = "interactive",
                 slo_shed_error_rate: Optional[float] = None,
                 slo_shed_p99_ms: Optional[float] = None,
                 slo_clear_error_rate: Optional[float] = None,
                 slo_clear_p99_ms: Optional[float] = None,
                 slo_window: str = "10s",
                 slo_min_samples: int = 20,
                 slo_shed_classes: Tuple[str, ...] = ("batch",),
                 slo_check_interval_s: float = 0.1,
                 clock: Callable[[], float] = time.monotonic):
        if default_weight <= 0:
            raise ValueError("default_weight must be positive")
        if default_priority not in PRIORITIES:
            raise ValueError(
                f"default_priority must be one of {PRIORITIES}, got "
                f"{default_priority!r}")
        if slo_shed_error_rate is not None \
                and not (0.0 < slo_shed_error_rate <= 1.0):
            raise ValueError("slo_shed_error_rate must be in (0, 1]")
        if slo_shed_p99_ms is not None and slo_shed_p99_ms <= 0:
            raise ValueError("slo_shed_p99_ms must be positive")
        if slo_clear_error_rate is not None:
            if slo_shed_error_rate is None:
                raise ValueError(
                    "slo_clear_error_rate needs slo_shed_error_rate (a "
                    "clear threshold without a trip threshold can never "
                    "apply)")
            if not (0.0 < slo_clear_error_rate <= slo_shed_error_rate):
                raise ValueError(
                    f"slo_clear_error_rate must be in (0, "
                    f"slo_shed_error_rate={slo_shed_error_rate:g}] — a "
                    f"clear threshold above the trip threshold would "
                    f"un-shed while still tripping (got "
                    f"{slo_clear_error_rate})")
        if slo_clear_p99_ms is not None:
            if slo_shed_p99_ms is None:
                raise ValueError(
                    "slo_clear_p99_ms needs slo_shed_p99_ms (a clear "
                    "threshold without a trip threshold can never apply)")
            if not (0.0 < slo_clear_p99_ms <= slo_shed_p99_ms):
                raise ValueError(
                    f"slo_clear_p99_ms must be in (0, "
                    f"slo_shed_p99_ms={slo_shed_p99_ms:g}] (got "
                    f"{slo_clear_p99_ms})")
        if slo_min_samples < 1:
            raise ValueError("slo_min_samples must be >= 1 (a near-empty "
                             "window must not trip batch-wide shedding)")
        if slo_check_interval_s < 0:
            raise ValueError("slo_check_interval_s must be >= 0 (the "
                             "window evaluation sorts its samples; a "
                             "negative TTL would re-run it per submit)")
        for c in slo_shed_classes:
            if c not in PRIORITIES:
                raise ValueError(
                    f"slo_shed_classes entries must be in {PRIORITIES}, "
                    f"got {c!r}")
        self.tenants: Dict[str, TenantPolicy] = {}
        for name, tp in (tenants or {}).items():
            if isinstance(tp, dict):
                tp = TenantPolicy(**tp)
            if not isinstance(tp, TenantPolicy):
                raise TypeError(
                    f"tenant {name!r}: expected TenantPolicy or dict, got "
                    f"{type(tp).__name__}")
            self.tenants[str(name)] = tp
        self.default_weight = float(default_weight)
        self.default_priority = default_priority
        self.slo_shed_error_rate = slo_shed_error_rate
        self.slo_shed_p99_ms = slo_shed_p99_ms
        self.slo_clear_error_rate = slo_clear_error_rate
        self.slo_clear_p99_ms = slo_clear_p99_ms
        self.slo_window = slo_window
        self.slo_min_samples = int(slo_min_samples)
        self.slo_shed_classes = tuple(slo_shed_classes)
        self.slo_check_interval_s = float(slo_check_interval_s)
        self.clock = clock
        self._default = TenantPolicy(weight=self.default_weight,
                                     priority=self.default_priority)
        # quota buckets live ON the policy, not per queue: the policy IS
        # the contract, so a deployment-scoped policy shared by N engines
        # enforces one tenant rate across all of them (mirroring the
        # deployment-shared RetryBudget) instead of silently granting N×
        self._buckets: Dict[Tuple[str, str], TokenBucket] = {}
        self._bucket_lock = threading.Lock()

    def tenant(self, name: str) -> TenantPolicy:
        return self.tenants.get(name, self._default)

    def quota_bucket(self, name: str,
                     unit: str = "rows") -> Optional[TokenBucket]:
        """The tenant's (lazily created, policy-shared) quota bucket, or
        None for unmetered tenants. Keyed by (tenant, cost ``unit``):
        engines of the SAME unit share one rate (the deployment-scoped
        contract), but a policy serving both engine kinds does not merge
        incomparable units — a rows/s debit from the batch engine must
        not shed the tenant's generation traffic, whose cost is
        requests. Bounded: only tenants explicitly configured with a
        quota ever mint a bucket, at most one per unit."""
        tp = self.tenant(name)
        if tp.quota is None:
            return None
        key = (name, unit)
        with self._bucket_lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                burst = tp.quota_burst if tp.quota_burst is not None \
                    else max(tp.quota, 1.0)
                bucket = self._buckets[key] = TokenBucket(
                    tp.quota, burst, clock=self.clock)
            return bucket

    def to_dict(self) -> dict:
        """JSON-safe description of the policy, for logging/dashboards
        (the metrics-side roll-up is ``ServingMetrics.qos_snapshot``)."""
        return {
            "tenants": {n: {"weight": t.weight, "priority": t.priority,
                            "quota": t.quota, "quota_burst": t.quota_burst,
                            "max_queued": t.max_queued,
                            "preemptible": t.preemptible}
                        for n, t in self.tenants.items()},
            "default_weight": self.default_weight,
            "default_priority": self.default_priority,
            "slo_shed_error_rate": self.slo_shed_error_rate,
            "slo_shed_p99_ms": self.slo_shed_p99_ms,
            "slo_clear_error_rate": self.slo_clear_error_rate,
            "slo_clear_p99_ms": self.slo_clear_p99_ms,
            "slo_window": self.slo_window,
            "slo_shed_classes": list(self.slo_shed_classes),
        }


def resolve_qos(policy: Optional[QosPolicy], tenant: Optional[str],
                priority: Optional[str]) -> Tuple[str, str]:
    """Normalize a submit()'s identity: ``tenant=None`` maps to the shared
    :data:`DEFAULT_TENANT`, ``priority=None`` to the tenant's configured
    class (or ``interactive`` without a policy). Validation lives here so
    both engines reject a bad priority identically, policy or not.

    A tenant EXPLICITLY configured in the policy cannot escalate above
    its configured class via the ``priority=`` keyword — otherwise the
    flooding batch tenant the policy exists to contain would escape both
    strict-priority ordering and the SLO-burn governor (which sheds
    batch first) with one argument. Voluntary DOWNGRADE (an interactive
    tenant deferring work to batch) is allowed, as is any priority for
    tenants the policy does not name (they are default-trust)."""
    tenant = DEFAULT_TENANT if tenant is None else str(tenant)
    if priority is None:
        priority = (policy.tenant(tenant).priority if policy is not None
                    else "interactive")
    if priority not in PRIORITIES:
        raise ValueError(
            f"priority must be one of {PRIORITIES}, got {priority!r}")
    if policy is not None and tenant in policy.tenants:
        configured = policy.tenants[tenant].priority
        if PRIORITIES.index(priority) < PRIORITIES.index(configured):
            raise ValueError(
                f"tenant {tenant!r} is configured {configured!r} and may "
                f"not escalate to {priority!r} (downgrades are allowed)")
    return tenant, priority


class TenantQueues:
    """Priority-strict, weighted-fair multi-queue — the drop-in
    replacement for the :class:`AdmissionController`'s single deque when
    a :class:`QosPolicy` is configured.

    Deliberately deque-shaped (``append`` / ``popleft`` / ``appendleft``
    / ``[0]`` / ``len`` / ``iter`` / ``clear``) so the controller's
    take/close/requeue logic is IDENTICAL for both queue kinds — the
    only difference is which request ``[0]`` designates: the FIFO head
    there, the fair-share head here. ``[0]`` followed by ``popleft()``
    always designates the same request (selection is a pure function of
    the stored tags), which the controller's peek-then-pop relies on.

    Fairness is start-time fair queueing: request cost is its ``rows``;
    tags are ``start = max(V, tenant's last finish)``, ``finish = start
    + cost/weight``; dequeue takes the smallest finish tag (ties broken
    by arrival sequence — deterministic) within the highest non-empty
    priority class, and advances the virtual clock V to the winner's
    start tag. A tenant that backs off re-enters at the current V (no
    banked credit), a 3×-weight tenant drains 3× the cost units of a
    1×-weight tenant under contention, and one-tenant traffic is exact
    FIFO. NOT internally locked: the owning controller already serializes
    every access under its condition lock."""

    def __init__(self, policy: QosPolicy, unit: str = "rows"):
        self.policy = policy
        self.unit = unit   # quota-bucket cost unit (rows | requests)
        # priority -> tenant -> deque[Request]; tenant sub-queues are FIFO
        self._classes: Dict[str, Dict[str, deque]] = {
            p: {} for p in PRIORITIES}
        self._vtime = 0.0
        # (tenant, priority) -> last finish tag. Keyed per CLASS: tags
        # are only ever compared within a class (strict priority decides
        # between classes), and a single per-tenant chain would let a
        # tenant's queued-but-unserved batch backlog inflate its own
        # interactive requests' start tags — virtual-service debt for
        # work that by definition cannot run before them
        self._finish: Dict[Tuple[str, str], float] = {}
        self._len = 0
        self._seq = 0   # arrival tiebreak: equal finish tags pop in order
        self._prunes = 0
        self._head: Optional[Request] = None   # cached _select result
        # queued cost units per tenant (across both classes) — the
        # max_queued backlog bound's ledger; entries drop at zero so
        # rotating tenant ids don't grow it
        self._queued_cost: Dict[str, int] = {}

    def _cost_delta(self, req: Request, d: int):
        c = self._queued_cost.get(req.tenant, 0) + d * req.rows
        if c > 0:
            self._queued_cost[req.tenant] = c
        else:
            self._queued_cost.pop(req.tenant, None)

    # ------------------------------------------------------- depth bound
    def check_depth(self, req: Request):
        """Per-tenant backlog gate (TenantPolicy.max_queued): admitting
        ``req`` must not push its tenant's queued cost past the bound —
        excess sheds typed 'quota_exceeded' BEFORE the rate bucket is
        charged (a backlog shed should not also drain the tenant's
        quota) and before global capacity, so one tenant's standing
        backlog cannot convert into queue-full for everyone else."""
        tp = self.policy.tenant(req.tenant)
        if tp.max_queued is None:
            return
        cur = self._queued_cost.get(req.tenant, 0)
        if cur + req.rows > tp.max_queued:
            raise QuotaExceededError(
                f"tenant {req.tenant!r} has {cur} {self.unit} queued; "
                f"admitting {req.rows} more would exceed its max_queued "
                f"bound of {tp.max_queued} — drain or back off",
                tenant=req.tenant, quota=tp.quota)

    # ---------------------------------------------------------------- quota
    def charge_quota(self, req: Request):
        """Debit ``req.rows`` cost units from the tenant's quota bucket
        (held by the POLICY, so engines sharing one policy share one
        rate); raises :class:`QuotaExceededError` when the bucket is dry.
        Tokens are NOT refunded if the request is later rejected for
        capacity — quota meters offered load, not served load."""
        tp = self.policy.tenant(req.tenant)
        bucket = self.policy.quota_bucket(req.tenant, unit=self.unit)
        if bucket is None:
            return
        if req.rows > bucket.burst:
            # structurally unsatisfiable: the bucket caps at burst, so
            # this request can NEVER pass no matter how long the tenant
            # backs off — say so (same typed reason; the KV-exhausted
            # precedent for never-fits demands), instead of a rate-limit
            # message that implies retrying will help
            raise QuotaExceededError(
                f"tenant {req.tenant!r}: request of {req.rows} cost "
                f"unit(s) exceeds its quota burst of {bucket.burst:g} "
                f"and can never be admitted — split the request or raise "
                f"quota_burst", tenant=req.tenant, quota=tp.quota)
        if not bucket.try_take(float(req.rows)):
            raise QuotaExceededError(
                f"tenant {req.tenant!r} exceeded its quota of "
                f"{tp.quota:g}/s (burst {bucket.burst:g}); request of "
                f"{req.rows} cost unit(s) shed", tenant=req.tenant,
                quota=tp.quota)

    # -------------------------------------------------------- deque surface
    def append(self, req: Request):
        w = self.policy.tenant(req.tenant).weight
        key = (req.tenant, req.priority)
        start = max(self._vtime, self._finish.get(key, 0.0))
        finish = start + req.rows / w
        self._finish[key] = finish
        req.qos_start_tag = start
        req.qos_finish_tag = finish
        self._seq += 1
        req.qos_seq = self._seq
        self._classes[req.priority].setdefault(
            req.tenant, deque()).append(req)
        self._len += 1
        self._cost_delta(req, +1)
        self._head = None

    def appendleft(self, req: Request):
        """Return a just-popped request to the head of its tenant queue
        WITHOUT re-stamping tags (the paged scheduler's requeue-head path:
        the request keeps its place in the fair order)."""
        self._classes[req.priority].setdefault(
            req.tenant, deque()).appendleft(req)
        self._len += 1
        self._cost_delta(req, +1)
        self._head = None

    def _select(self) -> Optional[Request]:
        """Current head: smallest finish tag (arrival-seq tiebreak) in
        the highest non-empty class. Cached until the next mutation, so
        the controller's peek-then-pop pays ONE scan, not two, under the
        admission lock."""
        if self._head is not None:
            return self._head
        for p in PRIORITIES:
            tenants = self._classes[p]
            best = None
            for q in tenants.values():
                if not q:
                    continue
                head = q[0]
                if best is None or (head.qos_finish_tag, head.qos_seq) < \
                        (best.qos_finish_tag, best.qos_seq):
                    best = head
            if best is not None:
                self._head = best
                return best
        return None

    def __getitem__(self, i: int) -> Request:
        if i != 0:
            raise IndexError("TenantQueues only exposes the head")
        head = self._select()
        if head is None:
            raise IndexError("empty queue")
        return head

    def popleft(self) -> Request:
        head = self._select()
        if head is None:
            raise IndexError("pop from an empty queue")
        self._head = None
        q = self._classes[head.priority][head.tenant]
        q.popleft()
        if not q:
            # prune drained per-tenant state: tenant ids are arbitrary
            # caller strings, so with rotating ids an undeleted empty
            # deque per tenant would grow _select's scan (under the
            # admission lock, on the dispatch hot path) and memory
            # without bound
            del self._classes[head.priority][head.tenant]
        self._vtime = max(self._vtime, head.qos_start_tag)
        self._len -= 1
        self._cost_delta(head, -1)
        if self._len == 0:
            # idle reset (standard SFQ): an empty system has no backlog
            # to be fair against — virtual time jumps past every
            # outstanding finish tag and the per-tenant tags clear,
            # which also bounds ``_finish`` for any workload that ever
            # drains (rotating tenant ids included)
            self._vtime = max(self._vtime, head.qos_finish_tag,
                              max(self._finish.values(), default=0.0))
            self._finish.clear()
        else:
            self._maybe_prune_finish()
        return head

    def _maybe_prune_finish(self):
        """Drop finish tags the virtual clock has passed — they carry no
        information (append stamps ``start = max(V, tag)``, and a tag
        <= V never wins the max). Amortized: every 256 pops, so one-shot
        tenants cannot grow ``_finish`` forever."""
        self._prunes += 1
        if self._prunes % 256:
            return
        v = self._vtime
        self._finish = {t: f for t, f in self._finish.items() if f > v}

    def forget_unserved(self, req: Request):
        """A dequeued request was SHED, not served (the controller's
        expired-head branch): when that leaves the tenant with nothing
        queued in that class, drop its finish tag — ``popleft`` cannot
        tell shed from service, and banking virtual-service debt for
        unserved work would deprioritize the tenant's next request
        (the same rule :meth:`remove_expired` applies on its path)."""
        cls = self._classes[req.priority]
        if req.tenant not in cls or not cls[req.tenant]:
            self._finish.pop((req.tenant, req.priority), None)

    def remove_expired(self, now: float) -> List[Request]:
        """Unlink every deadline-expired request across all tenant queues
        (the :meth:`AdmissionController.expire_queued` sweep); caller
        fails their futures outside the lock."""
        shed: List[Request] = []
        for p, tenants in self._classes.items():
            for tenant in list(tenants):
                q = tenants[tenant]
                # one expired() pass per request on the common
                # nothing-expired path — this sweep runs every dispatcher
                # turn under the admission lock when deadlines are active
                dead = [r for r in q if r.expired(now)]
                if not dead:
                    continue
                shed.extend(dead)
                keep = deque(r for r in q if not r.expired(now))
                if keep:
                    tenants[tenant] = keep
                else:
                    del tenants[tenant]
                    # every queued request expired UNSERVED: drop the
                    # (tenant, class) finish tag rather than carry it
                    # as virtual-service debt — the next request would
                    # otherwise start behind competitors for work never
                    # received (expiry is involuntary; the
                    # no-banked-credit rule's mirror image). Partial
                    # expiry keeps the chain: survivors' tags embed
                    # expired siblings' cost, bounded by the surviving
                    # queue depth.
                    self._finish.pop((tenant, p), None)
        self._len -= len(shed)
        for r in shed:
            self._cost_delta(r, -1)
        if shed:
            self._head = None
            # mirror popleft's bookkeeping: an expiry-drain must not
            # leave per-tenant finish tags accumulating (rotating tenant
            # ids + short deadlines would otherwise grow _finish with
            # popleft never running), nor skip the idle reset
            if self._len == 0:
                self._vtime = max(self._vtime,
                                  max(self._finish.values(), default=0.0))
                self._finish.clear()
            else:
                self._maybe_prune_finish()
        return shed

    def __len__(self) -> int:
        return self._len

    def __iter__(self) -> Iterator[Request]:
        for p in PRIORITIES:
            for tenant in sorted(self._classes[p]):
                yield from self._classes[p][tenant]

    def clear(self):
        for tenants in self._classes.values():
            tenants.clear()
        self._finish.clear()
        self._queued_cost.clear()
        self._len = 0
        self._head = None

    # -------------------------------------------------------------- insight
    def depth_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for tenants in self._classes.values():
            for tenant, q in tenants.items():
                if q:
                    out[tenant] = out.get(tenant, 0) + len(q)
        return out


class SloBurnGovernor:
    """Feeds the rolling SLO windows back into admission: when the
    configured window is *burning* — its :data:`BURN_REASONS` error rate
    or success p99 over threshold — requests in ``slo_shed_classes``
    (batch, by default) shed typed ``slo_shed`` at submit. Interactive
    traffic keeps flowing; the window is rolling, so the governor
    re-opens by itself as the burn clears.

    ``stats()`` over a window sorts its samples, so the verdict is cached
    for ``slo_check_interval_s`` (default 100 ms) — the submit hot path
    pays a clock read and a tuple compare. The cached verdict also lands
    in the ``slo_burn_active`` metrics gauge so ``qos_snapshot`` shows whether
    the governor is currently shedding.

    Hysteresis (``slo_clear_error_rate`` / ``slo_clear_p99_ms``): the
    governor TRIPS at the shed thresholds but, once burning, only
    CLEARS when the signal falls below its clear threshold — a window
    hovering at the trip point holds steady instead of oscillating
    ``slo_shed`` on/off each check interval. Hysteresis is PER SIGNAL:
    each signal's clear threshold applies only while that signal itself
    is holding a burn — otherwise a transient p99 trip would swap the
    error rate onto ITS (lower) clear threshold and a steady error rate
    the operator configured as acceptable could latch the governor
    burning forever. Unset clear thresholds fall back to the trip
    thresholds (no hysteresis)."""

    def __init__(self, policy: QosPolicy, metrics):
        self.policy = policy
        self.metrics = metrics
        self.enabled = (policy.slo_shed_error_rate is not None
                        or policy.slo_shed_p99_ms is not None)
        if self.enabled and policy.slo_window not in metrics.slo_windows:
            # fail at engine construction, not silently-never-shed: a
            # typo'd window name would otherwise leave the operator
            # believing burn protection is active while _evaluate finds
            # no window and admits everything forever
            raise ValueError(
                f"slo_window {policy.slo_window!r} does not name a "
                f"rolling SLO window (metrics has "
                f"{sorted(metrics.slo_windows)}); align the policy with "
                f"ServingMetrics(slo_windows_s=...)")
        self._lock = threading.Lock()
        self._checked_at = float("-inf")
        self._burning = False
        self._detail = ""
        # per-signal hold state (hysteresis): which signal is burning
        self._err_burning = False
        self._p99_burning = False

    def burning(self) -> Tuple[bool, str]:
        if not self.enabled:
            return False, ""
        now = time.monotonic()
        with self._lock:
            if now - self._checked_at < self.policy.slo_check_interval_s:
                return self._burning, self._detail
            self._checked_at = now
            was = (self._err_burning, self._p99_burning)
        err_b, p99_b, detail = self._evaluate(was)
        burning = err_b or p99_b
        with self._lock:
            self._err_burning, self._p99_burning = err_b, p99_b
            self._burning, self._detail = burning, detail
        self.metrics.slo_burn_active.set(1.0 if burning else 0.0)
        return burning, detail

    def _evaluate(self, was: Tuple[bool, bool] = (False, False)
                  ) -> Tuple[bool, bool, str]:
        """(error-rate burning, p99 burning, detail). ``was`` is the
        previous per-signal hold state and selects which threshold each
        signal is judged against: its trip threshold when idle, its
        clear threshold (hysteresis — defaulting to the trip value when
        unset) while IT is holding a burn. Per-signal on purpose: one
        signal's trip must never lower the other's bar, or a steady
        sub-trip signal would latch the governor shut forever."""
        win = self.metrics.slo_windows.get(self.policy.slo_window)
        if win is None:
            return False, False, ""
        s = win.stats()
        burn_errors = sum(n for r, n in s["errors_by_reason"].items()
                          if r in BURN_REASONS)
        # the denominator mirrors the numerator's shed-exclusion:
        # successes + burn failures only. Dividing by ALL terminals would
        # let admission sheds (quota_exceeded, queue_full, the governor's
        # own slo_shed) dilute the rate — a window of 50 model_errors +
        # 950 quota sheds is a 100%-failing dispatch path, not a 5% one
        eligible = s["ok"] + burn_errors
        if eligible < self.policy.slo_min_samples:
            return False, False, ""
        details = []
        err_b = p99_b = False
        rate = burn_errors / eligible
        trip = self.policy.slo_shed_error_rate
        if trip is not None:
            thr = self.policy.slo_clear_error_rate \
                if was[0] and self.policy.slo_clear_error_rate is not None \
                else trip
            if rate >= thr:
                err_b = True
                kind = "clear threshold (hysteresis)" if thr != trip \
                    else "threshold"
                details.append(
                    f"burn error rate {rate:.3f} >= {kind} {thr:g} over "
                    f"the {self.policy.slo_window} window "
                    f"({burn_errors}/{eligible} burn-eligible)")
        trip = self.policy.slo_shed_p99_ms
        if trip is not None and s["ok"] > 0:
            thr = self.policy.slo_clear_p99_ms \
                if was[1] and self.policy.slo_clear_p99_ms is not None \
                else trip
            if s["p99_ms"] >= thr:
                p99_b = True
                kind = "clear threshold (hysteresis)" if thr != trip \
                    else "threshold"
                details.append(
                    f"p99 {s['p99_ms']:.1f} ms >= {kind} {thr:g} ms over "
                    f"the {self.policy.slo_window} window")
        return err_b, p99_b, "; ".join(details)

    def gate(self, priority: str) -> Optional[SloShedError]:
        """The submit-time check: returns the typed error to shed with
        (caller raises + accounts it), or None to admit. EVERY submit
        pays the (cached, ~100 ms TTL) burn check so the
        ``slo_burn_active`` gauge tracks reality even when shed-class
        traffic backs off entirely; only shed-class requests can
        actually be refused."""
        if not self.enabled:
            return None
        burning, detail = self.burning()
        if not burning or priority not in self.policy.slo_shed_classes:
            return None
        return SloShedError(
            f"SLO burning ({detail}); shedding {priority!r}-class traffic "
            f"until the window clears", detail=detail)


class SpecAcceptanceGovernor:
    """Per-tenant draft-acceptance feedback for speculative decoding
    (serving/generation.py ``speculative=SpecConfig(...)``): the verify
    step reports each tenant's (proposed, accepted) draft-token counts
    after every speculative turn, and a tenant whose observed acceptance
    rate falls below ``min_acceptance`` — judged only after
    ``min_proposed`` proposals, so a cold stream's first turns cannot
    demote it — is DEMOTED to k=0: its traffic stops paying the
    draft+verify overhead that its rejections were wasting, and the
    scheduler runs plain decode turns for it instead. Demotion is per
    tenant and sticky (acceptance is a property of the tenant's traffic
    distribution vs the draft model, not a transient), and it is a pure
    SCHEDULING decision: emitted tokens are always the target model's
    own samples, so demotion — like speculation itself — is
    bitwise-inert.

    ``min_acceptance <= 0`` disables demotion (every record is still
    tracked for the acceptance-rate snapshot). Cardinality is bounded
    like the metrics tenant counters: at most ``max_tenants`` distinct
    labels, the rest folded into the shared overflow label."""

    OVERFLOW_TENANT = "(other)"

    def __init__(self, min_acceptance: float = 0.0,
                 min_proposed: int = 256, max_tenants: int = 1024):
        if min_proposed <= 0:
            raise ValueError(
                f"min_proposed must be positive (a zero observation "
                f"floor would demote tenants on no evidence), got "
                f"{min_proposed}")
        self.min_acceptance = float(min_acceptance)
        self.min_proposed = int(min_proposed)
        self.max_tenants = int(max_tenants)
        self._lock = threading.Lock()
        self._proposed: Dict[str, int] = {}
        self._accepted: Dict[str, int] = {}
        self._demoted: set = set()

    def _label(self, tenant: Optional[str]) -> str:
        t = tenant if tenant is not None else DEFAULT_TENANT
        if t in self._proposed or len(self._proposed) < self.max_tenants:
            return t
        return self.OVERFLOW_TENANT

    def record(self, tenant: Optional[str], proposed: int, accepted: int):
        """One tenant's draft outcome for one speculative turn."""
        if proposed <= 0:
            return
        with self._lock:
            t = self._label(tenant)
            p = self._proposed[t] = self._proposed.get(t, 0) + int(proposed)
            a = self._accepted[t] = self._accepted.get(t, 0) + int(accepted)
            if self.min_acceptance > 0.0 and t not in self._demoted \
                    and p >= self.min_proposed \
                    and a / p < self.min_acceptance:
                self._demoted.add(t)

    def demoted(self, tenant: Optional[str]) -> bool:
        """True when ``tenant``'s traffic should run k=0 (plain decode)."""
        if self.min_acceptance <= 0.0:
            return False
        with self._lock:
            t = self._label(tenant)
            return t in self._demoted

    def acceptance_rate(self, tenant: Optional[str]) -> Optional[float]:
        with self._lock:
            t = self._label(tenant)
            p = self._proposed.get(t, 0)
            return self._accepted.get(t, 0) / p if p else None

    def snapshot(self) -> dict:
        """Per-tenant acceptance roll-up (rides the engine's metrics
        payload beside the metrics counters)."""
        with self._lock:
            return {
                t: {"proposed": p,
                    "accepted": self._accepted.get(t, 0),
                    "acceptance_rate": self._accepted.get(t, 0) / p
                    if p else 0.0,
                    "demoted": t in self._demoted}
                for t, p in self._proposed.items()}


__all__ = ["QosPolicy", "TenantPolicy", "TenantQueues", "TokenBucket",
           "SloBurnGovernor", "SpecAcceptanceGovernor", "resolve_qos",
           "DEFAULT_TENANT", "PRIORITIES", "BURN_REASONS"]
