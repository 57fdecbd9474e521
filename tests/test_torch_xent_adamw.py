"""Parity of the port's fused softmax cross-entropy and fused AdamW
(deeplearning4j_tpu_torch/ops/xent_kernels.py, ops/pallas_updaters.py) with the
JAX package's Pallas kernels, on the CPU.

Both packages get the same numpy-drawn inputs; dtypes are pinned because
the test suite runs JAX with x64 enabled. JAX runs its kernels with
``interpret=True``, as its own tests do; the port's wrappers take their
plain versions for CPU tensors. The last test composes the BERT MLM step
from the public entry points (forward, fused cross-entropy, fused AdamW)
in both packages and compares three steps.
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.ops.pallas_kernels import (
    _xent_forward, softmax_cross_entropy as jxent)
from deeplearning4j_tpu.ops.pallas_updaters import fused_adamw as jfused
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.ops import xent_kernels
from deeplearning4j_tpu_torch.ops.pallas_updaters import fused_adamw, tree_leaves
from deeplearning4j_tpu_torch.ops.xent_kernels import (
    softmax_cross_entropy, softmax_cross_entropy_forward)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_ULP = 2 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch side of these tests is small; one intra-op thread keeps it
    from competing for every core with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _xent_inputs(n, v, seed):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((n, v))).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    return x, t, w


def _both(x, dtype):
    """The same values in both packages: numpy fp32 rounded to ``dtype``
    (round to nearest even on both sides)."""
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def _within_ulp(a, b):
    """|a - b| <= one bf16 ulp of b, plus 1e-7 for values near 0."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all(np.abs(a - b) <= BF16_ULP * np.abs(b) + 1e-7))


# ----------------------------------------------------------------- row 7


@pytest.mark.parametrize("n,v,block_n,dtype", [
    (16, 1000, 8, "float32"), (16, 1000, 4, "float32"),
    (16, 1000, 8, "bfloat16"), (200, 333, 8, "float32")])
def test_forward_matches_jax(n, v, block_n, dtype):
    x, t, _ = _xent_inputs(n, v, n + v)
    jx, tx = _both(x, dtype)
    jloss, jlse = _xent_forward(jx, jnp.asarray(t), block_n, True)
    tloss, tlse = softmax_cross_entropy_forward(tx, torch.from_numpy(t),
                                                block_n)
    assert tloss.dtype == tlse.dtype == torch.float32
    assert jloss.dtype == jlse.dtype == jnp.float32
    # fp32 on both sides over the same (rounded) logits; only the order of
    # the V-term exp-sum differs
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-6)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_targets_outside_the_vocabulary_add_nothing(dtype):
    """Targets -1, V and beyond: the masked sum adds 0, so the loss is the
    lse, and the gradient has no onehot — as in the JAX package."""
    n, v = 16, 100
    x, t, w = _xent_inputs(n, v, 5)
    t[:4] = [-1, v, -7, v + 3]
    jx, tx = _both(x, dtype)
    jloss, jlse = _xent_forward(jx, jnp.asarray(t), 8, True)
    tloss, tlse = softmax_cross_entropy_forward(tx, torch.from_numpy(t))
    np.testing.assert_array_equal(tloss[:4].numpy(), tlse[:4].numpy())
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-6,
                               atol=1e-6)
    jgrad = jax.grad(lambda lg: jnp.sum(jxent(lg, jnp.asarray(t), 8, True)
                                        * jnp.asarray(w)))(jx)
    tx.requires_grad_()
    (tgrad,) = torch.autograd.grad(
        (softmax_cross_entropy(tx, torch.from_numpy(t).long())
         * torch.from_numpy(w)).sum(), tx)
    assert (tgrad[:4] > 0).all()   # softmax * w > 0 everywhere: no onehot
    assert _within_ulp(tgrad.float().numpy(),
                       np.asarray(jgrad.astype(jnp.float32)))


# ----------------------------------------------------------------- row 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_matches_jax(dtype):
    x, t, w = _xent_inputs(16, 1000, 6)
    jx, tx = _both(x, dtype)
    jgrad = jax.grad(lambda lg: jnp.sum(jxent(lg, jnp.asarray(t), 8, True)
                                        * jnp.asarray(w)))(jx)
    tx.requires_grad_()
    (tgrad,) = torch.autograd.grad(
        (softmax_cross_entropy(tx, torch.from_numpy(t)) * torch.from_numpy(w))
        .sum(), tx)
    assert tgrad.dtype == TDT[dtype] and jgrad.dtype == JDT[dtype]
    got, want = tgrad.float().numpy(), np.asarray(jgrad.astype(jnp.float32))
    if dtype == "float32":
        # (exp(x - lse) - onehot) * w in fp32 on both sides: exp's last ulp
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        # the same fp32 value rounded to bf16 on both sides: an element at a
        # rounding boundary may land one bf16 ulp away
        assert _within_ulp(got, want)


def test_both_packages_refuse_n_off_the_block():
    """block_n only validates: N must divide by min(block_n, N) in both."""
    with pytest.raises(AssertionError):
        _xent_forward(jnp.zeros((12, 10), jnp.float32),
                      jnp.zeros(12, jnp.int32), 8, True)
    with pytest.raises(ValueError, match="block_n"):
        softmax_cross_entropy(torch.zeros(12, 10),
                              torch.zeros(12, dtype=torch.long))
    # min(block_n, N) = N: a short batch is one block in both
    _xent_forward(jnp.zeros((6, 10), jnp.float32), jnp.zeros(6, jnp.int32),
                  8, True)
    softmax_cross_entropy(torch.zeros(6, 10), torch.zeros(6, dtype=torch.long))


def test_double_backward_raises():
    x = torch.randn(8, 16, dtype=torch.float32, requires_grad=True)
    t = torch.arange(8)
    (g,) = torch.autograd.grad(softmax_cross_entropy(x, t).sum(), x,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="first-order"):
        g.sum().backward()


def test_cpu_tensors_take_the_plain_versions():
    """No launch is counted for CPU tensors, on any of the three rows."""
    before = (softmax_cross_entropy.launches,
              xent_kernels.softmax_cross_entropy_backward.launches,
              fused_adamw.launches)
    x = torch.randn(8, 32, requires_grad=True)
    softmax_cross_entropy(x, torch.arange(8)).sum().backward()
    opt = fused_adamw(1e-3)
    p = {"w": torch.randn(4, 4)}
    opt.apply(p, opt.init(p), {"w": torch.ones(4, 4)})
    assert (softmax_cross_entropy.launches,
            xent_kernels.softmax_cross_entropy_backward.launches,
            fused_adamw.launches) == before


# ----------------------------------------------------------------- row 9


def _np_tree(seed, dtype=np.float32):
    """tests/test_pallas_updaters.py's tree: a lane-divisible leaf, one
    with a partial final grid block, and a tiny one on the jnp path."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((1024, 128)).astype(dtype),
            "e": (0.1 * rng.standard_normal((3000, 128))).astype(dtype),
            "b": rng.standard_normal(7).astype(dtype)}


def _grads(step, shapes):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _run_both(lr, wd, steps, dtype):
    """``steps`` applies of each package's fused AdamW to the same tree
    and the same numpy gradients. Returns (JAX params, JAX adam state,
    port params, port state)."""
    npp = _np_tree(0)
    shapes = {k: a.shape for k, a in npp.items()}
    jf = jfused(lr, weight_decay=wd, interpret=True)
    tf = fused_adamw(lr, weight_decay=wd)
    jp = {k: jnp.asarray(a).astype(JDT[dtype]) for k, a in npp.items()}
    tp = {k: torch.from_numpy(a).to(TDT[dtype]) for k, a in npp.items()}
    jst, tst = jf.init(jp), tf.init(tp)
    for i in range(steps):
        g = _grads(i, shapes)
        jp, jst = jf.apply(jp, jst, {k: jnp.asarray(a).astype(JDT[dtype])
                                     for k, a in g.items()})
        tp, tst = tf.apply(tp, tst, {k: torch.from_numpy(a).to(TDT[dtype])
                                     for k, a in g.items()})
    adam = next(s for s in jst if hasattr(s, "mu"))
    return jp, adam, tp, tst


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_trajectory_matches_jax(wd):
    jp, adam, tp, tst = _run_both(3e-3, wd, 4, "float32")
    assert int(adam.count) == tst["count"] == 4
    keys = sorted(jp)   # tree_leaves order
    for k, tm, tv in zip(keys, tst["mu"], tst["nu"]):
        # the same fp32 operations in the same order; the bias corrections'
        # fp32 power may differ by an ulp between the libraries
        for got, want in ((tp[k], jp[k]), (tm, adam.mu[k]),
                          (tv, adam.nu[k])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_adamw_bf16_tree_keeps_its_dtypes():
    jp, adam, tp, tst = _run_both(3e-3, 0.01, 2, "bfloat16")
    for k, tm, tv in zip(sorted(jp), tst["mu"], tst["nu"]):
        for got, want in ((tp[k], jp[k]), (tm, adam.mu[k]),
                          (tv, adam.nu[k])):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            # fp32 math rounded to bf16 on both sides: one bf16 ulp
            assert _within_ulp(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32))), k


def test_default_weight_decay_is_optax():
    """Both defaults are optax.adamw's 1e-4 (make_train_step uses 0.01),
    and the default decays: with g = 0 the update is lr * 1e-4 * p."""
    assert inspect.signature(fused_adamw).parameters[
        "weight_decay"].default == 1e-4
    assert inspect.signature(jfused).parameters["weight_decay"].default \
        == 1e-4
    opt = fused_adamw(0.5)
    p = {"w": torch.ones(3)}
    opt.apply(p, opt.init(p), {"w": torch.zeros(3)})
    want = np.float32(1.0) - np.float32(0.5) * np.float32(1e-4)
    np.testing.assert_array_equal(p["w"].numpy(), np.full(3, want))


def test_init_is_make_train_steps_state():
    cfg = tbert.TransformerConfig(vocab_size=64, hidden=32, layers=2,
                                  heads=4, mlp_dim=64, max_seq=16,
                                  dtype=torch.float32)
    params = tbert.init_params(cfg, device="cpu")
    init_state, _ = tbert.make_train_step(cfg)
    a, b = init_state(params), fused_adamw(1e-4).init(params)
    assert a.keys() == b.keys() == {"count", "mu", "nu"}
    assert a["count"] == b["count"] == 0
    for key in ("mu", "nu"):
        assert len(a[key]) == len(b[key]) == len(tree_leaves(params))
        for x, y, p in zip(a[key], b[key], tree_leaves(params)):
            assert x.shape == y.shape == p.shape
            assert x.dtype == y.dtype == p.dtype
            assert not y.any()


def test_apply_updates_in_place():
    params = {"a": torch.randn(5, 3), "b": [torch.randn(7)]}
    opt = fused_adamw(1e-2)
    state = opt.init(params)
    storage = [x.data_ptr() for x in
               tree_leaves(params) + state["mu"] + state["nu"]]
    before = [x.clone() for x in tree_leaves(params)]
    grads = [torch.ones(5, 3), torch.ones(7)]   # leaves, tree_leaves order
    out_p, out_s = opt.apply(params, state, grads)
    assert out_p is params and out_s is state and state["count"] == 1
    assert [x.data_ptr() for x in tree_leaves(params) + state["mu"]
            + state["nu"]] == storage
    for x, x0 in zip(tree_leaves(params), before):
        assert not torch.equal(x, x0)


def test_mismatched_leaves_are_refused():
    opt = fused_adamw(1e-3)
    p = {"a": torch.zeros(4), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="leaves"):
        opt.apply(p, opt.init(p), [torch.zeros(4)])
    with pytest.raises(ValueError, match="shapes"):
        opt.apply(p, opt.init(p), {"a": torch.zeros(4), "b": torch.zeros(3)})


# ------------------------------------------------------ the slice as a whole

# a narrow BERT MLM: vocab x hidden = 65536, so tok_emb and lm_head take the
# JAX package's Pallas AdamW path and every other leaf its jnp path
SLICE = dict(vocab_size=1024, hidden=64, layers=2, heads=4, mlp_dim=128,
             max_seq=32, remat=False, attention_impl="flash")
LR, WD = 1e-4, 0.01


def test_composed_mlm_steps_match_jax():
    """Three MLM steps composed from the public entry points — the
    forward, softmax_cross_entropy over the (B*T, V) logits, the weighted
    mean, fused_adamw(...).apply — in both packages, fp32."""
    jcfg = jbert.TransformerConfig(dtype=jnp.float32, **SLICE)
    tcfg = tbert.TransformerConfig(dtype=torch.float32, **SLICE)
    v = SLICE["vocab_size"]
    rng = np.random.default_rng(7)
    npp = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jbert.init_params(jax.random.PRNGKey(0), jcfg))
    batch = {"tokens": rng.integers(0, v, (2, 32)).astype(np.int32),
             "targets": rng.integers(0, v, (2, 32)).astype(np.int32),
             "weights": (rng.random((2, 32)) > 0.3).astype(np.float32)}

    def jloss(params, b):
        logits = jbert._forward_raw(params, b["tokens"], jcfg)
        per_row = jxent(logits.reshape(-1, v), b["targets"].reshape(-1), 8,
                        True)
        w = b["weights"].reshape(-1)
        return jnp.sum(per_row * w) / jnp.maximum(jnp.sum(w), 1.0)

    jgrad = jax.jit(jax.value_and_grad(jloss))
    jopt = jfused(LR, weight_decay=WD, interpret=True)
    japply = jax.jit(jopt.apply)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    jst = jopt.init(jp)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}

    topt = fused_adamw(LR, weight_decay=WD)
    tp = tbert.params_from_numpy(npp, device="cpu")
    tst = topt.init(tp)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    for _ in range(3):
        jl, jg = jgrad(jp, jb)
        jp, jst = japply(jp, jst, jg)
        tree, xs = tbert.grad_aliases(tp)
        logits = tbert._forward_raw(tree, tb["tokens"].long(), tcfg)
        per_row = softmax_cross_entropy(logits.reshape(-1, v),
                                        tb["targets"].reshape(-1))
        w = tb["weights"].reshape(-1)
        tl = (per_row * w).sum() / w.sum().clamp_min(1.0)
        grads = torch.autograd.grad(tl, xs)
        topt.apply(tp, tst, grads)
        # fp32 both sides: the loss reassociates (1e-6) and, after the
        # first step, carries AdamW's last-ulp differences (1e-5)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert tst["count"] == 3
    h = SLICE["hidden"]
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            tree_leaves(tp)):
        t, j = t.numpy(), np.asarray(j)
        if "qkv" in jax.tree_util.keystr(path) and j.ndim == 1:
            # the key third of the qkv bias has an analytically zero
            # gradient: Adam turns each side's fp32 noise into steps of up
            # to lr either way, so it agrees only to 2 x 3 steps x lr
            np.testing.assert_allclose(t[h:2 * h], j[h:2 * h], rtol=0,
                                       atol=6 * LR)
            t, j = np.delete(t, np.s_[h:2 * h]), np.delete(j, np.s_[h:2 * h])
        # AdamW's order and association on both sides: 1e-5 relative,
        # 1e-6 absolute near zero
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))

