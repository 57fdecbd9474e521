"""Model-flops accounting for training throughput — the port's copy of
``mfu``, ``MFU_BASIS``, ``transformer_flops_per_token`` and
``non_embedding_params`` from ``deeplearning4j_tpu/profiler/profiler.py``.

``mfu`` takes the device's peak explicitly: the reference's default is a
TPU's, and no peak is assumed here. For an NVIDIA H100 SXM the data
sheet's dense bf16 tensor-core rate is 989e12 FLOP/s at 700 W.

``cuda_launches`` reads what a call launched on the card from the
profiler's own record of each kernel: its name, grid, block and shared
memory per block (static and dynamic, as the device reported them).
"""
from __future__ import annotations

import json
import os
import tempfile

MFU_BASIS = "analytic_model_flops: 6*N_nonemb + 12*L*H*T per token"


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak_flops: float) -> float:
    """Model FLOPs utilization against ``peak_flops`` (FLOP/s)."""
    return tokens_per_sec * flops_per_token / peak_flops


def transformer_flops_per_token(n_params_non_embedding: int, layers: int,
                                hidden: int, seq_len: int) -> float:
    """Analytic model flops per trained token for a dense transformer:
    6*N (fwd 2N + bwd 4N matmul flops on non-embedding params) plus the
    attention interior 12*L*H*T (QK^T + PV, fwd+bwd). The standard
    PaLM-appendix accounting; no remat recompute included."""
    return 6 * n_params_non_embedding + 12 * layers * hidden * seq_len


def non_embedding_params(params, cfg) -> int:
    """Non-embedding parameter count of the flagship transformer's tree
    (tensor elements; the tok/pos embedding tables are excluded, the
    untied lm_head stays in) — the N of
    :func:`transformer_flops_per_token`."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(count(v) for v in tree)
        return int(tree.numel())

    return count(params) - cfg.vocab_size * cfg.hidden \
        - cfg.max_seq * cfg.hidden


def cuda_launches(fn) -> list:
    """Run ``fn()`` once under ``torch.profiler`` and return the CUDA
    kernels it launched, in launch order: ``[{"name", "grid", "block",
    "shared_memory"}]``, ``shared_memory`` the bytes one block holds as
    the device tracer (CUPTI) recorded them. Needs a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    return [{"name": e["name"], "grid": e["args"]["grid"],
             "block": e["args"]["block"],
             "shared_memory": e["args"]["shared memory"]} for e in kernels]
