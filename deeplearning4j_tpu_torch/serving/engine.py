"""Bucketing helper shared by the serving engines (counterpart:
``bucket_ladder`` in ``deeplearning4j_tpu/serving/engine.py``; the
batching ``InferenceEngine`` there is not ported yet)."""
from __future__ import annotations

from typing import Tuple


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
