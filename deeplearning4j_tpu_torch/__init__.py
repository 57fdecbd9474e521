"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package keeps its
module layout and names (``models/bert.py``, ``serving/generation.py``,
``serving/paging.py``, ``ops/...``) so each function has an obvious
counterpart, and it imports neither ``jax`` nor anything of
``deeplearning4j_tpu``.

Precision: fp32 stays exact everywhere. The JAX package pins exact fp32
matmuls only when its platform is the CPU (``deeplearning4j_tpu/__init__.py``);
this package turns TF32 off for both cuBLAS matmuls and cuDNN on every
device, so an fp32 model computes in true fp32 on the card as on the host.
The serving main path is unaffected: its matmuls run in the model's
compute dtype (bf16 at full width).

Device: entry points take an explicit ``device`` that defaults to
``"cuda"``. Without CUDA they raise unless the caller passes
``device="cpu"`` (:func:`default_device`) — nothing silently runs on the
host in place of the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Resolve an entry point's ``device`` argument: ``None`` means
    ``"cuda"``. A CUDA device without an available card raises — pass
    ``device="cpu"`` to run the plain PyTorch versions on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: deeplearning4j_tpu_torch runs on the "
            "GPU by default — pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
