"""Gradient checking (counterpart: ``deeplearning4j_tpu/utils/
gradientcheck.py``; ref: org.deeplearning4j.gradientcheck.GradientCheckUtil
— "THE correctness backbone for every layer").

Central-difference numerical gradients against the autograd gradients of
the network's loss, per parameter, in float64 (the reference forces
global DOUBLE). The parameters are flattened in the reference's
``ravel_pytree`` order (layer by layer, a graph's nodes and each layer's
keys sorted), so the same ``seed`` checks the same parameter indices and
a failure names the same index in both packages. The network's own
dtype is float64 for the duration of a check (its inputs join it) and
restored after.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map, tree_unflatten


def _f64(tree):
    return tree_map(lambda t: t.detach().to(torch.float64)
                    if isinstance(t, torch.Tensor) and t.is_floating_point() else t,
                    tree)


@contextmanager
def _float64(net):
    prev = net._dtype
    net._dtype = torch.float64
    try:
        yield
    finally:
        net._dtype = prev


def _flat_errors(loss_fn: Callable, params64, epsilon, subset, seed) -> List[tuple]:
    """(index, analytic, numeric, relative error, absolute error) for each
    checked flat parameter index, in the order checked."""
    leaves = [l.detach().clone().requires_grad_() for l in tree_leaves(params64)]
    loss = loss_fn(tree_unflatten(params64, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat_g = np.concatenate([np.zeros(l.numel()) if g is None
                             else g.detach().cpu().numpy().ravel()
                             for l, g in zip(leaves, grads)]) if leaves else np.zeros(0)
    flat_p = np.concatenate([l.detach().cpu().numpy().ravel() for l in leaves]) \
        if leaves else np.zeros(0)
    shapes = [l.shape for l in leaves]
    sizes = [l.numel() for l in leaves]
    device = leaves[0].device if leaves else "cpu"

    def unravel(flat):
        out, off = [], 0
        for shp, n in zip(shapes, sizes):
            out.append(torch.as_tensor(flat[off:off + n], dtype=torch.float64,
                                       device=device).reshape(shp))
            off += n
        return tree_unflatten(params64, out)

    n = flat_p.shape[0]
    rng = np.random.default_rng(seed)
    idxs = np.arange(n) if subset is None or subset >= n else rng.choice(n, subset, replace=False)
    rows = []
    with torch.no_grad():
        for i in idxs:
            plus = flat_p.copy()
            plus[i] += epsilon
            minus = flat_p.copy()
            minus[i] -= epsilon
            numeric = (float(loss_fn(unravel(plus))) - float(loss_fn(unravel(minus)))) \
                / (2 * epsilon)
            a = float(flat_g[i])
            abs_err = abs(a - numeric)
            denom = max(abs(a), abs(numeric))
            rows.append((int(i), a, numeric, abs_err / denom if denom > 0 else 0.0, abs_err))
    return rows


def _report(rows, max_rel_error, min_abs_error, print_failures, label, what) -> bool:
    failures = [(i, a, num, rel) for i, a, num, rel, ab in rows
                if rel > max_rel_error and ab > min_abs_error]
    if failures and print_failures:
        for i, a, numv, rel in failures[:20]:
            print(f"  {what}[{i}]: analytic={a:.8g} numeric={numv:.8g} relErr={rel:.3g}")
        if label:
            print(f"{label} FAILED: {len(failures)}/{len(rows)}"
                  + (" params exceed tolerance" if label == "GradientCheck" else ""))
    return not failures


def gradient_errors(net, x, y, epsilon: float = 1e-6, subset: Optional[int] = 128,
                    seed: int = 12345) -> List[tuple]:
    """The rows a MultiLayerNetwork check compares: (flat index, analytic,
    numeric, relative error, absolute error) per checked parameter, in
    the order checked (``check_gradients`` judges them)."""
    dev = net.device
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float64, device=dev)
    state = _f64(net._state)

    def loss_fn(params):
        loss, _, _ = net._loss_for(params, state, x, y, None, None, None)
        return loss

    with _float64(net):
        return _flat_errors(loss_fn, _f64(net._params), epsilon, subset, seed)


def check_gradients(net, x, y, epsilon: float = 1e-6, max_rel_error: float = 1e-3,
                    min_abs_error: float = 1e-8, subset: Optional[int] = 128,
                    seed: int = 12345, print_failures: bool = True) -> bool:
    """Gradient-check a MultiLayerNetwork on a batch. Checks up to ``subset``
    randomly-chosen parameters (the reference checks all; subset keeps CI
    fast — pass None to check everything)."""
    rows = gradient_errors(net, x, y, epsilon, subset, seed)
    return _report(rows, max_rel_error, min_abs_error, print_failures,
                   "GradientCheck", "param")


def check_function_gradients(fn, *args, epsilon: float = 1e-6, max_rel_error: float = 1e-3,
                             min_abs_error: float = 1e-8, argnum: int = 0,
                             subset: Optional[int] = 64, seed: int = 0,
                             print_failures: bool = True) -> bool:
    """Gradient-check an arbitrary scalar-valued torch function in float64
    (the OpValidation analog for single ops)."""
    args = [torch.as_tensor(np.asarray(a)) for a in args]
    args = [a.to(torch.float64) if a.is_floating_point() else a for a in args]
    target = args[argnum]

    def loss_fn(leaves):
        return fn(*args[:argnum], leaves[0], *args[argnum + 1:])

    rows = _flat_errors(loss_fn, [target], epsilon, subset, seed)
    return _report(rows, max_rel_error, min_abs_error, print_failures, None, "x")


def check_gradients_graph(graph, inputs, labels, epsilon: float = 1e-6,
                          max_rel_error: float = 1e-3,
                          min_abs_error: float = 1e-8,
                          subset: Optional[int] = 128, seed: int = 12345,
                          print_failures: bool = True) -> bool:
    """ComputationGraph variant of check_gradients (ref: GradientCheckUtil.
    checkGradients(ComputationGraph, ...)). ``inputs``/``labels`` are lists
    matching networkInputs/networkOutputs order."""
    dev = graph.device
    inputs = {name: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)
              for name, x in zip(graph.conf.networkInputs,
                                 inputs if isinstance(inputs, (list, tuple))
                                 else [inputs])}
    labels = [torch.as_tensor(np.asarray(y), dtype=torch.float64, device=dev)
              for y in (labels if isinstance(labels, (list, tuple)) else [labels])]
    state = _f64(graph._state)

    def loss_fn(params):
        loss, _ = graph._loss_for(params, state, inputs, labels, None, None)
        return loss

    with _float64(graph):
        rows = _flat_errors(loss_fn, _f64(graph._params), epsilon, subset, seed)
    return _report(rows, max_rel_error, min_abs_error, print_failures,
                   "GraphGradientCheck", "param")
