"""Fused in-place AdamW, written by hand in CUDA C++ for sm_90a
(``ops/csrc/adamw.cu``), beside its plain PyTorch version — the
counterpart of ``deeplearning4j_tpu/ops/pallas_updaters.py``
(``fused_adamw``, ``_adamw_leaf``).

:func:`fused_adamw` returns ``(init, apply)``. ``init`` builds the state
that ``make_train_step``'s ``init_state`` builds (``{"count", "mu",
"nu"}``, moments in :func:`tree_leaves` order); ``apply`` takes the
gradients and updates params and moments in place, at ``optax.adamw``'s
semantics, with no intermediate updates tree. On the card one call is ONE
launch over every leaf; on the CPU each leaf takes :func:`adamw_reference`.
The launch count is ``fused_adamw.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple

import torch

from deeplearning4j_tpu_torch.ops._launch import launch, route, stream_ptr

_CODES = {torch.float32: 0, torch.bfloat16: 1}
# elements per CTA of the kernel (a multiple of 4): 32 per thread
_CHUNK = 8192


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree in a fixed order (dict keys sorted,
    lists in order), so params and optimizer moments pair up — the order
    of ``jax.tree_util.tree_leaves`` on the same tree."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    return [tree]


def adamw_reference(p, g, m, v, bc1: float, bc2: float, *, lr: float,
                    b1: float, b2: float, eps: float, wd: float):
    """Plain version of the kernel for one leaf: exactly the arithmetic of
    ``_adamw_jnp`` — fp32 math, ``m = b1 m + (1 - b1) g``, ``v = b2 v +
    (1 - b2) g^2``, ``p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)``,
    each result in its operand's own dtype. Returns new ``(p, m, v)``.

    The bias corrections divide as 0-dim tensors on p's device: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, one
    more rounding than the true division of the kernel and the JAX
    package."""
    bc1 = torch.full((), bc1, dtype=torch.float32, device=p.device)
    bc2 = torch.full((), bc2, dtype=torch.float32, device=p.device)
    g32 = g.float()
    m_new = b1 * m.float() + (1 - b1) * g32
    v_new = b2 * v.float() + (1 - b2) * (g32 * g32)
    p32 = p.float()
    p_new = p32 - lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                        + wd * p32)
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


class FusedAdamW(NamedTuple):
    """``(init, apply)``: ``init(params)`` builds the state; ``apply(params,
    opt_state, grads)`` returns ``(params, opt_state)``, both updated in
    place."""
    init: Any
    apply: Any


def bias_corrections(count: int, b1: float, b2: float):
    """``(1 - b1 ** count, 1 - b2 ** count)`` taken in fp32, as the JAX
    package takes them: the arguments of :func:`adamw_reference` at step
    ``count`` (counted from 1)."""
    t = torch.tensor(float(count), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    return (float(one - torch.tensor(b1, dtype=torch.float32) ** t),
            float(one - torch.tensor(b2, dtype=torch.float32) ** t))


def _check_leaves(ps, gs, ms, vs) -> None:
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"params, grads and moments hold {len(ps)}, "
                         f"{len(gs)}, {len(ms)}, {len(vs)} leaves")
    for k, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"leaf {k}: shapes differ: p {tuple(p.shape)}, "
                             f"g {tuple(g.shape)}, m {tuple(m.shape)}, "
                             f"v {tuple(v.shape)}")


def fused_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 1e-4) -> FusedAdamW:
    """AdamW at ``optax.adamw``'s semantics, defaults included (weight
    decay 1e-4, not ``make_train_step``'s 0.01): eps outside the sqrt,
    the count incremented before the bias corrections ``1 - b ** count``
    (taken in fp32), the decoupled decay ``wd * p`` added to the update of
    every leaf, then the update scaled by ``-learning_rate``. Math in fp32,
    each result cast back to its operand's dtype (fp32 or bf16).

    ``apply(params, opt_state, grads)`` takes ``grads`` as a tree shaped
    like ``params`` or as its leaves in :func:`tree_leaves` order (what
    ``torch.autograd.grad`` returns for the leaves of ``grad_aliases``).
    It updates the params and the moments IN PLACE — as the JAX kernel
    aliases them — and returns them with the state, whose count it
    increments. On the card it is one kernel launch for every leaf."""
    hyper = dict(lr=learning_rate, b1=b1, b2=b2, eps=eps, wd=weight_decay)
    table: Dict[str, Any] = {}   # the device leaf table of the last leaf set

    def init(params):
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    def leaf_table(ps, gs, ms, vs):
        """(device table, chunks): one row per leaf of p, m, v pointers,
        size, first chunk and the four dtype codes — built again only when
        a pointer, size or dtype changes."""
        key = tuple((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                     p.dtype, g.dtype, m.dtype, v.dtype)
                    for p, g, m, v in zip(ps, gs, ms, vs))
        if table.get("key") != key:
            rows, chunk0 = [], 0
            for p, g, m, v in zip(ps, gs, ms, vs):
                rows.append([p.data_ptr(), m.data_ptr(), v.data_ptr(),
                             p.numel(), chunk0] +
                            [_CODES[x.dtype] for x in (p, g, m, v)])
                chunk0 += -(-p.numel() // _CHUNK)
            table.update(key=key, chunks=chunk0, rows=torch.tensor(
                rows, dtype=torch.int64).to(ps[0].device))
        return table["rows"], table["chunks"]

    def launch_kernel(ps, gs, ms, vs, bc1, bc2):
        for x in (*ps, *gs, *ms, *vs):
            if x.dtype not in _CODES:
                raise TypeError(f"the adamw kernel takes float32 or bfloat16 "
                                f"operands, got {x.dtype}")
        if not all(x.is_contiguous() for x in (*ps, *ms, *vs)):
            raise ValueError("fused_adamw updates params and moments in "
                             "place: they must be contiguous")
        gs = [g.contiguous() for g in gs]
        rows, chunks = leaf_table(ps, gs, ms, vs)
        gptr = torch.tensor([g.data_ptr() for g in gs], dtype=torch.int64)
        gptr = gptr.pin_memory().to(ps[0].device, non_blocking=True)
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        launch("adamw", "adamw", [p, p, i, ll, ll] + [f] * 9 + [p],
               rows.data_ptr(), gptr.data_ptr(), len(ps), _CHUNK, chunks,
               learning_rate, b1, b2, 1 - b1, 1 - b2, eps, weight_decay, bc1,
               bc2, stream_ptr(ps[0].device))
        fused_adamw.launches += 1

    def apply(params, opt_state, grads):
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = opt_state["mu"], opt_state["nu"]
        _check_leaves(ps, gs, ms, vs)
        count = opt_state["count"] + 1
        bc1, bc2 = bias_corrections(count, b1, b2)
        if ps and route(*ps, *gs, *ms, *vs) == "cuda":
            launch_kernel(ps, gs, ms, vs, bc1, bc2)
        else:
            with torch.no_grad():
                for p, g, m, v in zip(ps, gs, ms, vs):
                    new = adamw_reference(p, g, m, v, bc1, bc2, **hyper)
                    for dst, src in zip((p, m, v), new):
                        dst.copy_(src)
        opt_state["count"] = count
        return params, opt_state

    return FusedAdamW(init=init, apply=apply)


fused_adamw.launches = 0
