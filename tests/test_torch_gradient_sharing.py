"""The port's gradient sharing (``deeplearning4j_tpu_torch/parallel/
gradient_sharing.py``) against the JAX package's optax transforms on the
CPU: ``threshold_encode``/``decode`` exactly, the residual held back and
when it crosses the threshold, the adaptive threshold's trajectory and
``int8_compression``'s updates, over several steps of a small seeded
tree, in the suite's 64-bit mode and in both packages' default modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import gradient_sharing as jgs
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.parallel import gradient_sharing as tgs

STEPS = 6


def _tree(seed, dtype=np.float32, scale=0.01):
    r = np.random.default_rng(seed)
    return {"w": (r.standard_normal((6, 5)) * scale).astype(dtype),
            "b": [(r.standard_normal(5) * scale).astype(dtype),
                  (r.standard_normal((2, 3)) * scale).astype(dtype)]}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return tgs.tree_map(torch.as_tensor, tree)


def _same(port_tree, ref_tree):
    """Equal bit for bit, leaf by leaf, dtypes too."""
    pl = tgs.tree_leaves(port_tree)
    rl = jax.tree_util.tree_leaves(ref_tree)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        r = np.asarray(r)
        assert str(p.dtype).replace("torch.", "") == r.dtype.name
        np.testing.assert_array_equal(p.numpy(), r)


def test_threshold_encode_decode_exact():
    g = np.array([0.5, -0.001, 0.002, -2.0, 0.01, -0.01, 0.0],
                 np.float32)
    for t in (0.01, np.float32(0.002)):
        want = jgs.threshold_encode(jnp.asarray(g), t)
        got = tgs.threshold_encode(torch.as_tensor(g), t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tgs.threshold_decode(got).numpy(),
            np.asarray(jgs.threshold_decode(want)))


def test_residual_carry_crosses_threshold_as_reference():
    """The reference test's case: 0.004 a step is held back until three
    steps cross 0.01, 0.02 is sent at once; the residuals match."""
    algo = dict(initial=0.01, decay=1.0)
    jtx = jgs.gradient_compression(jgs.AdaptiveThresholdAlgorithm(**algo))
    ttx = tgs.gradient_compression(tgs.AdaptiveThresholdAlgorithm(**algo))
    g = {"w": np.array([0.004, 0.0, 0.02], np.float32)}
    js, ts = jtx.init(_jax(g)), ttx.init(_torch(g))
    sent = []
    for _ in range(3):
        ju, js = jtx.update(_jax(g), js)
        tu, ts = ttx.update(_torch(g), ts)
        _same(tu, ju)
        _same(ts.residual, js.residual)
        sent.append(float(tu["w"][0]))
    assert sent[:2] == [0.0, 0.0] and sent[2] == pytest.approx(0.01)


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "default"])
@pytest.mark.parametrize("target,decay", [(1e-3, 1.05), (0.3, 1.5)])
def test_adaptive_compression_trajectory(x64, target, decay):
    """Several steps of seeded gradients: the sent updates, the residual
    and the threshold equal the reference's each step (the threshold
    grows while more than the target is sent, then shrinks)."""
    algo = dict(initial=0.004, target_sparsity=target, decay=decay,
                max_t=0.05)
    jtx = jgs.gradient_compression(jgs.AdaptiveThresholdAlgorithm(**algo))
    ttx = tgs.gradient_compression(tgs.AdaptiveThresholdAlgorithm(**algo))
    params = _tree(0)
    with jax.enable_x64(x64), nd.enableX64(x64):
        js, ts = jtx.init(_jax(params)), ttx.init(_torch(params))
        thresholds = []
        for step in range(STEPS):
            g = _tree(100 + step)
            ju, js = jtx.update(_jax(g), js)
            tu, ts = ttx.update(_torch(g), ts)
            _same(tu, ju)
            _same(ts.residual, js.residual)
            assert ts.threshold.dtype == torch.float32
            np.testing.assert_array_equal(ts.threshold.numpy(),
                                          np.asarray(js.threshold))
            thresholds.append(float(ts.threshold))
    assert len(set(thresholds)) > 1   # the threshold moved


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_int8_compression_updates(dtype):
    jtx, ttx = jgs.int8_compression(), tgs.int8_compression()
    params = _tree(1, dtype)
    js, ts = jtx.init(_jax(params)), ttx.init(_torch(params))
    assert ts == () == js
    for step in range(STEPS):
        g = _tree(200 + step, dtype, scale=10.0 ** (step - 3))
        ju, js = jtx.update(_jax(g), js)
        tu, ts = ttx.update(_torch(g), ts)
        _same(tu, ju)


def test_zero_gradients_keep_the_floor_scale():
    z = {"w": np.zeros((3, 4), np.float32)}
    ju, _ = jgs.int8_compression().update(_jax(z), ())
    tu, _ = tgs.int8_compression().update(_torch(z), ())
    _same(tu, ju)
