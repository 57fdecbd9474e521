"""Op families beyond the initial surface (counterpart:
``deeplearning4j_tpu/ops/extra_defs.py``).

For now only the four keys whose registrations in the reference's
``extra_defs.py`` replace ``math_defs.py``'s (the reference imports extra
after math, and the last registration wins): ``shape.dynamicPartition``,
``shape.sequenceMask``, ``math.clipByNorm`` and ``math.step``. Each port
key computes what the reference's registry computes. The file's other
112 keys are still to be ported (ROADMAP Queue 1, 9a-ii).
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.array import reduce as _reduce
from deeplearning4j_tpu_torch.ops.registry import op

# ------------------------------------------------------- partition / stitch


@op("dynamicPartition", "shape")
def dynamic_partition(x, partitions, num_partitions):
    """EAGER-ONLY (dynamic output shapes): list of num_partitions arrays."""
    return [x[partitions == i] for i in range(num_partitions)]


# ----------------------------------------------------------- sequence ops


@op("sequenceMask", "shape")
def sequence_mask(lengths, maxlen, dtype=torch.bool):
    lengths = torch.as_tensor(lengths)
    ar = torch.arange(maxlen, device=lengths.device)
    return (ar < lengths[..., None]).to(_dt.resolve(dtype))


# ------------------------------------------------------------- clipping


@op("clipByNorm", "math")
def clip_by_norm(x, clip_norm, axes=None):
    n = torch.sqrt(_reduce("sum", x * x, axes, keepdims=axes is not None))
    return x * torch.clamp_max(clip_norm / torch.clamp_min(n, 1e-12), 1.0)


# ------------------------------------------------------- special functions


op("step", "math")(lambda x: (x > 0).to(x.dtype))
