"""The parity harness of the registry tests (``tests/test_torch_ops*.py``):
one key's forward (every variant of its recipe in ``torch_op_cases``)
and gradient (the first variant: ``sum(op(x) * g)`` differentiated with
torch autograd and with ``jax.grad``), the port's registry against the
JAX package's on the CPU.

The reference runs under ``jax.jit``, one program a variant and one for
each gradient: on a shared CPU, compiling one program costs about a
quarter of dispatching its primitives one by one (7.2 s against 29.1 s
for 39 of the gradient cases), and keeps the registry tests within their
time. The keys whose reference output is not a function of traced arrays
(``EAGER``) run eagerly.

The suite runs the reference with ``jax_enable_x64`` on
(``tests/conftest.py``), so the port runs with its 64-bit switch on
(``nd.enableX64``) beside it. :func:`check_forward_32` holds both in
their default modes, the reference under ``jax.enable_x64(False)``.

Tolerances (``torch_op_cases``): float32 forward within 1e-5 |ref| + 1e-6
elementwise, gradients within 1e-4 of the largest |grad|, integer and
bool results exact and every output's dtype the reference's; a looser
tolerance stands beside its op there with why.
"""
import importlib
import inspect
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deeplearning4j_tpu.ops as jops
import deeplearning4j_tpu_torch.ops as tops
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from torch_op_cases import (
    ATOL, CASES, GRAD_REL, RTOL, flat_outputs, to_torch)

# keys whose reference cannot run under ``jax.jit``, each with why
EAGER = {
    # a list whose lengths depend on the data
    "shape.dynamicPartition",
    # Python ints out
    "shape.sizeAt", "shape.rank",
    # Python values out: a shape tuple, a bool of the dtype
    "shape.broadcastShape", "math.isNumericTensor",
    # an output length from the data: the largest index or value + 1
    "shape.dynamicStitch", "math.bincount",
    # outputs whose shape depends on the data
    "shape.unique", "shape.uniqueWithCounts", "shape.listDiff",
    "shape.intersection", "shape.whereNonzero",
    # host (numpy) computations on the array's values
    "math.hashCode", "math.checkNumerics", "math.assertOp",
    "loss.ctcGreedyDecoder",
}

# the four keys that ``extra_defs.py`` registers again (and wins) were
# ``math_defs.py``'s first
_FIRST_IN_MATH = {"shape.dynamicPartition", "shape.sequenceMask",
                  "math.clipByNorm", "math.step"}
HALF_ONE = ("math_defs", "nn_defs")


def _registered_in(name):
    """The keys a reference module registers by a literal ``op("name",
    "namespace")``, as every registration of the second half is."""
    src = inspect.getsource(importlib.import_module(
        f"deeplearning4j_tpu.ops.{name}"))
    return {f"{ns}.{n}" for n, ns in
            re.findall(r'op\(\s*"([^"]+)",\s*"([^"]+)"\s*\)', src)}


_SECOND_HALF = {m: _registered_in(m)
                for m in ("extra_defs", "more_defs", "wide_defs")}


def module_of(key):
    """The reference module (``math_defs``/``nn_defs`` as one half, or
    ``extra_defs``, ``more_defs``, ``wide_defs``) that defines ``key``."""
    if key in _FIRST_IN_MATH:
        return "math_defs"
    for m in ("wide_defs", "more_defs", "extra_defs"):
        if key in _SECOND_HALF[m]:
            return m
    return "math_defs" if jops.REGISTRY[key].namespace != "nn" \
        and key.split(".")[0] not in ("cnn", "rnn", "loss", "image") \
        else "nn_defs"


def keys_of(*namespaces, modules=HALF_ONE):
    """The keys of ``namespaces`` (all, when none is named) defined in the
    reference's ``modules``: by default its first half, ``math_defs.py``
    and ``nn_defs.py``."""
    return sorted(k for k in CASES
                  if (not namespaces or k.split(".", 1)[0] in namespaces)
                  and module_of(k) in modules)


def to_jax(x):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    if isinstance(x, list):
        return [to_jax(e) for e in x]
    if isinstance(x, tuple) and any(isinstance(e, np.ndarray) for e in x):
        return tuple(to_jax(e) for e in x)
    if isinstance(x, dict):
        return {k: to_jax(e) for k, e in x.items()}
    return x


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def rng(key, variant):
    return np.random.default_rng(zlib.crc32(f"{key}/{variant}".encode()))


def _arrays(args):
    """(position, index in a list or None) of every numpy array among the
    positional args (one level into lists)."""
    out = []
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            out.append((i, None))
        elif isinstance(a, list):
            out += [(i, j) for j, e in enumerate(a)
                    if isinstance(e, np.ndarray)]
    return out


def _substitute(args, where, values):
    args = [list(a) if isinstance(a, list) else a for a in args]
    for (i, j), val in zip(where, values):
        if j is None:
            args[i] = val
        else:
            args[i][j] = val
    return args


def _at(args, where):
    return [args[i] if j is None else args[i][j] for i, j in where]


def reference(key, args, kwargs):
    """The JAX package's op on the recipe's arguments: one jitted program
    over the positional arrays (the rest closed over), eager for
    ``EAGER``."""
    fn = jops.REGISTRY[key].fn
    if key in EAGER:
        return fn(*to_jax(args), **to_jax(kwargs))
    where = _arrays(args)
    jk = to_jax(kwargs)

    def run(*vals):
        return fn(*to_jax(_substitute(args, where, vals)), **jk)

    return jax.jit(run)(*[jnp.asarray(a) for a in _at(args, where)])


def port(key, args, kwargs, x64=True):
    """The port's op on the CPU (arrays made there, as by the creation
    keys, too)."""
    prev = _dt.defaults.device
    _dt.defaults.device = "cpu"
    try:
        with nd.enableX64(x64):
            return tops.REGISTRY[key].fn(*to_torch(args, "cpu"),
                                         **to_torch(kwargs, "cpu"))
    finally:
        _dt.defaults.device = prev


def close(a, b, rtol, atol, label):
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}"
    if b.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=label)
        return
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert (np.isnan(a64) == np.isnan(b64)).all(), f"{label}: NaNs differ"
    ok = np.isnan(b64) | (a64 == b64) | (
        np.abs(a64 - b64) <= rtol * np.abs(b64) + atol)
    assert ok.all(), (f"{label}: max |diff| "
                      f"{np.nanmax(np.abs(a64 - b64))} beyond "
                      f"{rtol} |ref| + {atol}")


def _check_dtype(p, r, label):
    if isinstance(p, torch.Tensor):
        want = np.asarray(r).dtype.name
        got = str(p.dtype).replace("torch.", "")
        assert got == want, f"{label}: dtype {got} != reference's {want}"


def compare(case, ref, out, label):
    """The port's outputs against the reference's by the case's rule."""
    rtol, atol = case.tol or (RTOL, ATOL)
    rl, pl = flat_outputs(ref), flat_outputs(out)
    assert len(rl) == len(pl), f"{label}: {len(pl)} outputs != {len(rl)}"
    for i, (p, r) in enumerate(zip(pl, rl)):
        _check_dtype(p, r, f"{label} output {i}")
    if case.compare == "svd":
        (u, s, vh), (ru, rs, rvh) = [[np_of(o) for o in x] for x in (pl, rl)]
        close(s, rs, rtol, atol, f"{label} singular values")
        k = s.shape[-1]
        close((u[:, :k] * s) @ vh[:k], (ru[:, :k] * rs) @ rvh[:k],
              1e-5, 1e-5, f"{label} U S Vh")
        close(u.T @ u, np.eye(u.shape[0]), 0, 1e-5, f"{label} U orthogonal")
        return
    if case.compare == "qr":
        (q, rr), (rq, rrr) = [[np_of(o) for o in x] for x in (pl, rl)]
        close(q @ rr, rq @ rrr, 1e-5, 1e-5, f"{label} QR")
        close(np.abs(rr), np.abs(rrr), 1e-5, 1e-5, f"{label} |R|")
        return
    if case.compare == "eig":
        (w, vv), (rw, rv) = [[np_of(o) for o in x] for x in (pl, rl)]
        close(w, rw, rtol, atol, f"{label} eigenvalues")
        close(np.abs(vv.T @ rv), np.eye(len(w)), 0, 1e-4,
              f"{label} eigenvectors up to sign")
        return
    if case.compare == "moments":
        (p,), (r,) = [[np_of(o) for o in x] for x in (pl, rl)]
        off = ~(np.abs(p - r) <= rtol * np.abs(r) + atol)
        assert off.mean() <= 0.01, f"{label}: {off.sum()} samples differ"
        np.testing.assert_allclose(p.mean(), r.mean(), rtol=2e-2)
        np.testing.assert_allclose(p.var(), r.var(), rtol=5e-2)
        return
    for i, (p, r) in enumerate(zip(pl, rl)):
        if isinstance(r, (int, float, bool)) and not isinstance(
                p, torch.Tensor):
            assert p == r, f"{label} output {i}: {p} != {r}"
            continue
        close(p, r, rtol, atol, f"{label} output {i}")


def check_forward(key):
    case = CASES[key]
    for variant, make in enumerate(case.variants):
        args, kwargs = make(rng(key, variant))
        compare(case, reference(key, args, kwargs), port(key, args, kwargs),
                f"{key} variant {variant}")


_TO_32 = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
          np.dtype(np.uint64): np.uint32,
          np.dtype(np.complex128): np.complex64}


def _arrays_32(x):
    """numpy arrays (through lists, tuples and dicts) in the dtype an
    array of the reference's default mode holds."""
    if isinstance(x, np.ndarray):
        return x.astype(_TO_32.get(x.dtype, x.dtype))
    if isinstance(x, (list, tuple)):
        return type(x)(_arrays_32(e) for e in x)
    if isinstance(x, dict):
        return {k: _arrays_32(e) for k, e in x.items()}
    return x


def check_forward_32(key):
    """Every variant with both packages in their default modes: the
    reference under ``jax.enable_x64(False)``, the port with its 64-bit
    switch off, on the recipe's arrays in their 32-bit dtypes (as each
    package's arrays would hold them); the outputs' dtypes and values
    by the same rules."""
    case = CASES[key]
    for variant, make in enumerate(case.variants):
        args, kwargs = map(_arrays_32, make(rng(key, variant)))
        with jax.enable_x64(False):
            ref = reference(key, args, kwargs)
        compare(case, ref, port(key, args, kwargs, x64=False),
                f"{key} variant {variant} (default mode)")


# ------------------------------------------------------------- gradients


def _float_leaves(args, positions):
    """The float arrays to differentiate: those at ``positions`` (None:
    every position), one level into lists."""
    return [(i, j) for i, j in _arrays(args)
            if (positions is None or i in positions)
            and _at(args, [(i, j)])[0].dtype.kind == "f"]


def grad_keys(keys):
    """The keys with a gradient case: a float array to differentiate in
    the first variant, unless the case says none."""
    out = []
    for key in keys:
        case = CASES[key]
        if case.grad == ():
            continue
        args, _ = case.variants[0](rng(key, 0))
        if _float_leaves(args, case.grad):
            out.append(key)
    return out


def check_gradient(key):
    """d/dx sum(op(x) * g) for the first variant's float arrays: torch
    autograd against ``jax.grad`` (one jitted program), within GRAD_REL
    of the largest |grad| of each argument."""
    case = CASES[key]
    args, kwargs = case.variants[0](rng(key, 0))
    diff = _float_leaves(args, case.grad)
    rest = [w for w in _arrays(args) if w not in diff]
    fn = jops.REGISTRY[key].fn
    jk = to_jax(kwargs)
    vals = [jnp.asarray(a) for a in _at(args, diff)]
    others = [jnp.asarray(a) for a in _at(args, rest)]

    def outputs(vals, others):
        full = _substitute(_substitute(args, diff, vals), rest, others)
        return flat_outputs(fn(*to_jax(full), **jk))

    g_rng = np.random.default_rng(zlib.crc32(f"{key}/g".encode()))
    gs = [g_rng.standard_normal(o.shape).astype(o.dtype)
          if np.dtype(o.dtype).kind == "f" else None
          for o in jax.eval_shape(outputs, vals, others)]
    assert any(g is not None for g in gs), f"{key}: no float output"

    def ref_loss(vals, others):
        return sum(jnp.sum(o * g) for o, g in zip(outputs(vals, others), gs)
                   if g is not None)

    ref_g = jax.jit(jax.grad(ref_loss))(vals, others)
    ts = [torch.tensor(a, requires_grad=True) for a in _at(args, diff)]
    out = flat_outputs(port(key, _substitute(args, diff, ts), kwargs))
    terms = [(o * torch.as_tensor(g)).sum() for o, g in zip(out, gs)
             if g is not None and isinstance(o, torch.Tensor)
             and o.requires_grad]
    port_g = torch.autograd.grad(sum(terms), ts, allow_unused=True) \
        if terms else [None] * len(ts)
    for n, (pg, rg, t) in enumerate(zip(port_g, ref_g, ts)):
        pg = np.zeros(t.shape, np.float32) if pg is None else np_of(pg)
        rg = np.asarray(rg)
        bound = GRAD_REL * max(np.abs(rg).max(), 1e-6)
        err = np.abs(pg.astype(np.float64) - rg).max()
        assert err <= bound, (f"{key} d/d(arg {diff[n]}): |diff| {err} "
                              f"beyond {bound}")
