"""What every kernel wrapper of the port shares: the ctypes call into a
kernel library (built on first use), the stream pointer, the rule that
routes CPU tensors to the plain version and CUDA tensors to the kernel,
and the first-order-only autograd backward."""
from __future__ import annotations

import ctypes
import functools

import torch
from torch._C import _functions as _autograd_functions

from deeplearning4j_tpu_torch.ops import _build

_bound = {}


def launch(source: str, entry: str, argtypes, *args):
    """Call C entry point ``entry`` of kernel library ``source`` (built on
    first use) and raise if the launch's cudaError_t is not 0. Every
    pointer and the stream are declared ``c_void_p`` (64-bit), never the
    ctypes default int."""
    bound = _bound.get(entry)
    if bound is None:
        lib = _build.load(source)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        bound = _bound[entry] = (fn, err)
    fn, err = bound
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def first_order_only(message: str):
    """A decorator like ``torch.autograd.function.once_differentiable``
    whose error is ``message``: the backward runs without recording a
    graph, and when the caller asked for one (``create_graph=True``) the
    gradients come back tied to a node that raises ``message`` if they are
    differentiated again."""
    def decorate(backward):
        @functools.wraps(backward)
        def wrapper(ctx, *grads):
            with torch.no_grad():
                out = backward(ctx, *grads)
            if not torch.is_grad_enabled():
                return out
            live = [i for i, o in enumerate(out) if o is not None]
            err = _autograd_functions.DelayedError(message.encode(),
                                                   len(live))
            tied = err(*[out[i].detach().requires_grad_() for i in live])
            tied = tied if isinstance(tied, tuple) else (tied,)
            out = list(out)
            for i, t in zip(live, tied):
                out[i] = t
            return tuple(out)
        return wrapper
    return decorate
