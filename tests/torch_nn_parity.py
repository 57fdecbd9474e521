"""The layer parity harness of ``tests/test_torch_nn_layers.py`` and
``tests/test_torch_nn_rnn.py``: each case of ``tests/torch_nn_cases.py``
run through the JAX package's layer (jitted once per case and mode) and
the port's on the same weights and inputs.

Tolerances, each relative to the largest |value| of the reference tensor
it checks: forward and state 1e-5, gradients 1e-4 (fp32 on both sides).
The callers turn the port's 64-bit switch on, as the suite runs the
reference with ``jax_enable_x64``: a dropout probability given as a
Python float then draws float64 uniforms on both sides, so the masks are
equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch.models import random as prng
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

import torch_nn_cases as C

FWD_REL, GRAD_REL = 1e-5, 1e-4
INIT_KEY, DROP_KEY = 3, 11


def close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max |err| {err:.3e} > {rel} x {scale:.3e}"


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference(case_id, training, masked):
    """(numpy params, numpy state, jitted f(params, state, x, mask, ct))
    -> ((grads wrt params[, x]), (out, new_state))."""
    layer, _ = C.build(jnn, case_id)
    params = layer.init_params(jax.random.key(INIT_KEY), jnp.float32)
    state = layer.init_state(jnp.float32)
    x, _ = C.inputs(case_id)
    float_x = np.issubdtype(x.dtype, np.floating)

    def f(params, state, x, mask, ct):
        kw = {"mask": mask} if masked else {}
        out, st = layer.apply(params, x, training=training,
                              rng=jax.random.key(DROP_KEY) if training else None,
                              state=state or None, **kw)
        return jnp.sum(out * ct), (out, st)

    argnums = (0, 2) if float_x else (0,)
    grad = jax.jit(jax.grad(f, argnums=argnums, has_aux=True))
    return np_tree(params), np_tree(state), grad


def run_port(case_id, training, masked, params, state):
    layer, _ = C.build(pnn, case_id)
    x, mask = C.inputs(case_id)
    float_x = np.issubdtype(x.dtype, np.floating)
    tp = tree_map(lambda a: torch.tensor(a).requires_grad_(), params)
    ts = tree_map(torch.tensor, state)
    xt = torch.tensor(x, requires_grad=float_x)
    kw = {"mask": torch.tensor(mask)} if masked else {}
    out, st = layer.apply(tp, xt, training=training,
                          rng=prng.prng_key(DROP_KEY) if training else None,
                          state=ts or None, **kw)
    ct = torch.tensor(C.cotangent(tuple(out.shape)))
    wrt = tree_leaves(tp) + ([xt] if float_x else [])
    grads = torch.autograd.grad((out * ct).sum(), wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)]
    return out.detach(), st, grads


def variants(ids):
    """pytest params (case, training, masked) of the cases in ``ids``."""
    for cid, _, _, masked in C.CASES:
        if cid not in ids:
            continue
        for training in (False, True):
            yield pytest.param(cid, training, False, id=f"{cid}-{'train' if training else 'infer'}")
        if masked:
            yield pytest.param(cid, True, True, id=f"{cid}-train-masked")


def check_case(case_id, training, masked):
    params, state, grad = reference(case_id, training, masked)
    out, st, grads = run_port(case_id, training, masked, params, state)
    x, mask = C.inputs(case_id)
    ct = C.cotangent(tuple(out.shape))
    ref_grads, (ref_out, ref_st) = grad(params, state, x,
                                        None if mask is None else mask, ct)
    close(out.numpy(), ref_out, FWD_REL, f"{case_id} forward")
    ref_st_leaves = jax.tree_util.tree_leaves(ref_st)
    st_leaves = tree_leaves(st) if st else []
    assert len(st_leaves) == len(ref_st_leaves)
    for a, b in zip(st_leaves, ref_st_leaves):
        close(a.detach().numpy(), b, FWD_REL, f"{case_id} state")
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    assert len(grads) == len(ref_leaves), (len(grads), len(ref_leaves))
    for i, (a, b) in enumerate(zip(grads, ref_leaves)):
        close(a.numpy(), b, GRAD_REL, f"{case_id} gradient {i}")
