"""Profiling, numerical-panic tooling and model-flops accounting
(counterpart: ``deeplearning4j_tpu/profiler/profiler.py``; ref:
org.nd4j.linalg.profiler.OpProfiler with ProfilerConfig's
checkForNAN/checkForINF 'panic modes', and deeplearning4j's
PerformanceListener timing hooks).

- ``OpProfiler`` — named wall-clock spans, nestable, exported as a Chrome
  trace, optionally merged with a serving ``Tracer``'s request lanes on
  one clock. The serving engine opens its ``serving.*`` spans on it.
- ``device_trace(logdir)`` — ``torch.profiler`` over the block (CPU and,
  with a card, CUDA activity), written as a Chrome trace into ``logdir``
  (the reference's ``jax.profiler.trace``).
- panic modes — ``ProfilerConfig(checkForNAN=True)`` makes attached
  ``ProfilingListener``s check score, parameters and gradients each
  iteration and raise ``PanicException`` on the first non-finite value
  (``check_tree_finite``: one reduction over the tree on its device, one
  read of three flags).
- ``cuda_launches`` reads what a call launches on the card from the CUDA
  driver: the call is captured into a CUDA graph and each kernel node
  gives its function's name, grid, block and shared memory per block
  (static and dynamic).
- ``mfu``, ``MFU_BASIS``, ``transformer_flops_per_token`` and
  ``non_embedding_params``: model-flops utilization. ``mfu`` takes the
  device's peak explicitly; ``peak_flops`` answers a card's dense bf16
  tensor-core rate from its CUDA device name (NVIDIA data sheets; an
  H100 SXM's 989e12 FLOP/s at 700 W) and raises for a card it does not
  know. No TPU peak is assumed anywhere.
"""
from __future__ import annotations

import ctypes
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

MFU_BASIS = "analytic_model_flops: 6*N_nonemb + 12*L*H*T per token"


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak_flops: float) -> float:
    """Model FLOPs utilization against ``peak_flops`` (FLOP/s)."""
    return tokens_per_sec * flops_per_token / peak_flops


# dense bf16 tensor-core peak by exact CUDA device name (NVIDIA's data
# sheet): the H100 SXM this port runs on
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def peak_flops(device=None) -> float:
    """The dense bf16 peak (FLOP/s) of a card: ``device`` is a CUDA
    device name, a ``torch.device`` or an index (default the current
    card). Raises ``ValueError`` for a card not in :data:`PEAK_FLOPS`."""
    if device is None or not isinstance(device, str):
        import torch

        index = device.index if hasattr(device, "index") else device
        device = torch.cuda.get_device_name(index or 0)
    if device in PEAK_FLOPS:
        return PEAK_FLOPS[device]
    raise ValueError(f"peak_flops: no peak rate known for {device!r}; "
                     f"pass the card's peak to mfu() explicitly")


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


# CUDA driver API values (cuda.h)
_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_FUNC_ATTRIBUTE_SHARED_SIZE_BYTES = 1


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h), with room to spare."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p),
                ("_spare", ctypes.c_byte * 64)]


def _graph_kernels(graph: int, device: int) -> list:
    """The kernel nodes of CUDA graph ``graph``, in the order they were
    captured, as the driver holds them."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed: CUresult {rc}")

    g = ctypes.c_void_p(graph)
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    out = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        p = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
             ctypes.byref(p))
        static = ctypes.c_int(0)
        name = ctypes.c_char_p()
        if p.func:   # a CUfunction, else a context-free CUkernel
            call("cuFuncGetAttribute", ctypes.byref(static),
                 _CU_FUNC_ATTRIBUTE_SHARED_SIZE_BYTES,
                 ctypes.c_void_p(p.func))
            call("cuFuncGetName", ctypes.byref(name),
                 ctypes.c_void_p(p.func))
        else:
            call("cuKernelGetAttribute", ctypes.byref(static),
                 _CU_FUNC_ATTRIBUTE_SHARED_SIZE_BYTES,
                 ctypes.c_void_p(p.kern), device)
            call("cuKernelGetName", ctypes.byref(name),
                 ctypes.c_void_p(p.kern))
        out.append({"name": (name.value or b"").decode(),
                    "grid": list(p.grid), "block": list(p.block),
                    "shared_memory": static.value + p.shared_mem_bytes})
    return out


def cuda_launches(fn) -> list:
    """The CUDA kernels one call of ``fn()`` launches, in launch order:
    ``[{"name", "grid", "block", "shared_memory"}]``. ``fn`` runs once to
    warm up, then once captured into a CUDA graph, and each kernel node is
    read from the driver: the function's (mangled) name, the grid, the
    block, and the shared memory one block holds, the function's static
    bytes plus the launch's dynamic bytes. Memory copies and sets are not
    kernels and are left out. Needs a card; ``fn`` must be capturable (no
    host sync) and launch the same kernels each call. (The profiler's
    kernel records drop launches: ``torch_tools/cuda_trace_drops.py``.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    try:
        return _graph_kernels(graph.raw_cuda_graph(),
                              torch.cuda.current_device())
    finally:
        graph.reset()


class PanicException(RuntimeError):
    """Non-finite value detected under panic mode (ref:
    ND4JOpProfilerException)."""


@dataclass
class ProfilerConfig:
    """(ref: org.nd4j.linalg.profiler.ProfilerConfig builder)."""

    checkForNAN: bool = False
    checkForINF: bool = False
    collectSpans: bool = True


def check_tree_finite(tree, what: str, check_nan=True, check_inf=True):
    """Raise PanicException if any float leaf of ``tree`` (dicts, lists,
    tuples of tensors) holds NaN (or Inf): one reduction on the leaves'
    device and one read of its three flags."""
    import torch

    from deeplearning4j_tpu_torch.ops.pallas_updaters import tree_leaves

    leaves = [l for l in tree_leaves(tree)
              if isinstance(l, torch.Tensor) and (l.is_floating_point()
                                                  or l.is_complex())]
    if not leaves:
        return
    flat = torch.cat([l.detach().reshape(-1).float() for l in leaves])
    ok, has_nan, has_inf = torch.stack([
        torch.isfinite(flat).all(), torch.isnan(flat).any(),
        torch.isinf(flat).any()]).tolist()
    if ok:
        return
    if check_nan and has_nan:
        raise PanicException(f"NaN detected in {what} (panic mode)")
    if check_inf and has_inf:
        raise PanicException(f"Inf detected in {what} (panic mode)")


@dataclass
class _Span:
    name: str
    start_us: float
    dur_us: float
    tid: int
    args: Optional[dict] = None


class OpProfiler:
    """Span collector with Chrome-trace export. Use
    ``with profiler.span("train_step"):`` around anything; nesting shows
    as Chrome trace's duration-event stacking per thread."""

    _instance: Optional["OpProfiler"] = None

    def __init__(self, config: Optional[ProfilerConfig] = None):
        self.config = config or ProfilerConfig()
        self._spans: List[_Span] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    @classmethod
    def getInstance(cls) -> "OpProfiler":
        if cls._instance is None:
            cls._instance = OpProfiler()
        return cls._instance

    def reset(self):
        with self._lock:
            self._spans = []
            self._t0 = time.perf_counter()

    @contextmanager
    def span(self, name: str, **args):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.config.collectSpans:
                end = time.perf_counter()
                with self._lock:
                    self._spans.append(_Span(
                        name=name, start_us=(start - self._t0) * 1e6,
                        dur_us=(end - start) * 1e6,
                        tid=threading.get_ident() % 100000,
                        args=args or None))

    def timeit(self, name: str, fn, *a, **kw):
        with self.span(name):
            return fn(*a, **kw)

    @property
    def spans(self) -> List[_Span]:
        with self._lock:
            return list(self._spans)

    def summary(self) -> dict:
        """name -> {count, total_ms, mean_ms} (ref: printOutDashboard)."""
        agg: dict = {}
        for s in self.spans:
            d = agg.setdefault(s.name, {"count": 0, "total_ms": 0.0})
            d["count"] += 1
            d["total_ms"] += s.dur_us / 1000.0
        for d in agg.values():
            d["mean_ms"] = d["total_ms"] / d["count"]
        return agg

    def export_chrome_trace(self, path: str, tracer=None) -> str:
        """Chrome-trace JSON of the collected spans (pid 1). Pass a
        ``serving.tracing.Tracer`` to merge its retained request traces
        into the same file on the same perf_counter clock: one lane per
        engine, one thread lane per request, beside the spans."""
        events = [{"name": s.name, "ph": "X", "ts": s.start_us,
                   "dur": s.dur_us, "pid": 1, "tid": s.tid,
                   **({"args": s.args} if s.args else {})}
                  for s in self.spans]
        if tracer is not None:
            events.append({"ph": "M", "name": "process_name", "pid": 1,
                           "args": {"name": "training"}})
            events.extend(tracer.chrome_events(t0=self._t0))
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


@contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block — CPU activity, and CUDA activity
    when a card is present — written as a Chrome trace,
    ``logdir/trace_<n>.json`` (a new ``n`` per call). Yields the
    profiler (its ``key_averages()`` and ``events()``)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{n}.json"))


class ProfilingListener(TrainingListener):
    """Per-iteration spans + panic checks as a listener (ref: the reference
    enables OpProfiler globally via the Nd4j environment; here it attaches
    to the fit loop it should watch). It reads the model's ``score()``,
    ``_params`` and, where the model keeps them (a network with a listener
    that ``requiresGradients``), ``_last_grads``."""

    def __init__(self, profiler: Optional[OpProfiler] = None,
                 config: Optional[ProfilerConfig] = None,
                 checkParams: bool = True, checkGradients: bool = True):
        self.profiler = profiler or OpProfiler.getInstance()
        if config is not None:
            self.profiler.config = config
        self.checkParams = checkParams
        self.checkGradients = checkGradients
        self._last_t: Optional[float] = None

    @property
    def requiresGradients(self) -> bool:
        cfg = self.profiler.config
        return self.checkGradients and (cfg.checkForNAN or cfg.checkForINF)

    def iterationDone(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_t is not None and self.profiler.config.collectSpans:
            with self.profiler._lock:
                self.profiler._spans.append(_Span(
                    name="iteration",
                    start_us=(self._last_t - self.profiler._t0) * 1e6,
                    dur_us=(now - self._last_t) * 1e6,
                    tid=0, args={"iteration": iteration, "epoch": epoch}))
        self._last_t = now

        cfg = self.profiler.config
        if not (cfg.checkForNAN or cfg.checkForINF):
            return
        score = model.score()
        if cfg.checkForNAN and np.isnan(score):
            raise PanicException(f"NaN score at iteration {iteration} (panic mode)")
        if cfg.checkForINF and np.isinf(score):
            raise PanicException(f"Inf score at iteration {iteration} (panic mode)")
        if self.checkParams:
            check_tree_finite(model._params, f"parameters@iter{iteration}",
                              cfg.checkForNAN, cfg.checkForINF)
        grads = getattr(model, "_last_grads", None)
        if self.checkGradients and grads is not None:
            check_tree_finite(grads, f"gradients@iter{iteration}",
                              cfg.checkForNAN, cfg.checkForINF)
