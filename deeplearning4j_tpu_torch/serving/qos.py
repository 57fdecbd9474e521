"""Multi-tenant QoS vocabulary of the serving engine (counterpart:
``deeplearning4j_tpu/serving/qos.py``). Only the priority classes are
ported so far: without a QoS policy a request's class orders nothing in
the queue, but preemption reads it (a stream never evicts a higher
class). The policy path — weighted-fair queues, quotas, the SLO-burn
governor — is not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

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
