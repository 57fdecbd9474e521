"""Multi-tenant QoS vocabulary of the serving engine (counterpart:
``deeplearning4j_tpu/serving/qos.py``). Ported so far: the priority
classes (without a QoS policy a request's class orders nothing in the
queue, but preemption reads it: a stream never evicts a higher class) and
the speculative decoding acceptance governor. The policy path —
weighted-fair queues, quotas, the SLO-burn governor — is not ported
yet."""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

#: Priority classes, highest first: ``interactive`` outranks ``batch``.
PRIORITIES = ("interactive", "batch")

#: The tenant of a request that names none.
DEFAULT_TENANT = "anon"


def resolve_qos(tenant: Optional[str], priority: Optional[str]
                ) -> Tuple[str, str]:
    """Normalize a submit()'s identity without a policy: ``tenant=None``
    is :data:`DEFAULT_TENANT`, ``priority=None`` is ``interactive``; a
    priority outside :data:`PRIORITIES` raises."""
    tenant = DEFAULT_TENANT if tenant is None else str(tenant)
    if priority is None:
        priority = "interactive"
    if priority not in PRIORITIES:
        raise ValueError(
            f"priority must be one of {PRIORITIES}, got {priority!r}")
    return tenant, priority


class SpecAcceptanceGovernor:
    """Per-tenant draft acceptance for speculative decoding: the engine
    reports each tenant's (proposed, accepted) draft tokens after every
    speculative turn, and a tenant whose acceptance rate falls below
    ``min_acceptance`` — judged only after ``min_proposed`` proposals — is
    demoted to k=0 (plain decode turns) for good. Emitted tokens are
    always the target's own samples, so demotion changes throughput,
    never a stream. ``min_acceptance <= 0`` never demotes. At most
    ``max_tenants`` labels are tracked, the rest folded into
    :data:`OVERFLOW_TENANT`."""

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
            return self._label(tenant) in self._demoted

    def acceptance_rate(self, tenant: Optional[str]) -> Optional[float]:
        with self._lock:
            t = self._label(tenant)
            p = self._proposed.get(t, 0)
            return self._accepted.get(t, 0) / p if p else None

    def snapshot(self) -> dict:
        """Per-tenant acceptance: proposed, accepted, rate, demoted."""
        with self._lock:
            return {
                t: {"proposed": p,
                    "accepted": self._accepted.get(t, 0),
                    "acceptance_rate": self._accepted.get(t, 0) / p
                    if p else 0.0,
                    "demoted": t in self._demoted}
                for t, p in self._proposed.items()}
