"""Parity of the port's training half (deeplearning4j_tpu_torch/models/bert.py
``lm_loss``, ``make_train_step`` and the attention routing) with the JAX
package, on the CPU.

Both packages get the same numpy-drawn parameters and batches; dtypes are
pinned because the test suite runs JAX with x64 enabled. The JAX side
reaches its Pallas kernels in interpret mode; the port's wrappers take
their plain versions for CPU tensors.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu_torch import profiler as tprofiler
from deeplearning4j_tpu_torch.models import bert as tbert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch side of these tests is small; one intra-op thread keeps it
    from competing for every core with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

# tests/test_models.py's TINY
TINY = dict(vocab_size=64, hidden=32, layers=2, heads=4, mlp_dim=64,
            max_seq=32)


def _configs(**kw):
    return (jbert.TransformerConfig(dtype=jnp.float32, **kw),
            tbert.TransformerConfig(dtype=torch.float32, **kw))


def _np_params(jcfg, seed=0):
    p = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _batch(vocab, B, T, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
            "targets": rng.integers(0, vocab, (B, T)).astype(np.int32),
            # a masked-LM-like weight pattern: some positions count 0
            "weights": (rng.random((B, T)) > 0.3).astype(np.float32)}


def _jax_tree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def _torch_loss_and_grads(np_params, batch, tcfg):
    tp = tbert.params_from_numpy(np_params, device="cpu")
    leaves = [x.requires_grad_() for x in tbert._leaves(tp)]
    loss = tbert.lm_loss(tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, tcfg)
    return loss, torch.autograd.grad(loss, leaves)


def _assert_grads_match(tgrads, jgrads, rel):
    # jax.tree_util orders dict keys sorted, as tbert._leaves does
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for t, j in zip(tgrads, jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=rel * max(np.abs(j).max(), 1e-6))


LR = 1e-4   # bench.py's learning rate


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(impl, causal):
    """The JAX package's loss and gradients on TINY with remat off. Remat
    changes memory, not results (the reference's checkpoint policy), so
    both remat cells of the port compare against this one run."""
    jcfg, _ = _configs(**TINY, causal=causal, remat=False,
                       attention_impl=impl)
    batch = _batch(TINY["vocab_size"], 4, 16)
    return jax.jit(jax.value_and_grad(jbert.lm_loss), static_argnums=2)(
        _jax_tree(_np_params(jcfg)),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["full", "flash", "ring"])
def test_loss_and_grads_match_jax(impl, causal, remat):
    jcfg, tcfg = _configs(**TINY, causal=causal, remat=remat,
                          attention_impl=impl)
    npp = _np_params(jcfg)
    batch = _batch(TINY["vocab_size"], 4, 16)
    jloss, jgrads = _jax_loss_and_grads(impl, causal)
    tloss, tgrads = _torch_loss_and_grads(npp, batch, tcfg)
    # fp32 both sides (flash: the packed kernel's plain version against
    # its Pallas kernel); sums reassociate: 1e-6 relative on the loss,
    # 1e-5 of each leaf's largest gradient
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    _assert_grads_match(tgrads, jgrads, 1e-5)


# A decay large enough to show in the parameters: over 5 steps it moves
# each leaf by 5 * LR * WD = 5e-4 of its value, 50x the trajectory's
# relative tolerance, so a step that dropped the decay, or masked biases
# and layernorms out of it, fails.
WD = 1.0


@pytest.mark.parametrize("remat", [False, True])
def test_adamw_trajectory_matches_jax(remat):
    """5 make_train_step steps (losses, params, count) against the JAX
    package's optax.adamw trajectory, on the MLM route (flash,
    bidirectional)."""
    jcfg, tcfg = _configs(**TINY, causal=False, remat=remat,
                          attention_impl="flash")
    rng = np.random.default_rng(3)
    # every leaf drawn away from zero (biases start at 0), so the decay
    # moves every leaf
    npp = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0.0, 0.05, a.shape)).astype(np.float32),
        _np_params(jcfg))
    batch = _batch(TINY["vocab_size"], 4, 16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    init, step = jbert.make_train_step(jcfg, learning_rate=LR,
                                       weight_decay=WD)
    jp = _jax_tree(npp)
    jst = init(jp)
    tinit, tstep = tbert.make_train_step(tcfg, learning_rate=LR,
                                         weight_decay=WD)
    tp = tbert.params_from_numpy(npp, device="cpu")
    tst = tinit(tp)
    for _ in range(5):
        jp, jst, jl = step(jp, jst, jbatch)
        tp, tst, tl = tstep(tp, tst, batch)
        # 1e-5 relative: beside the loss's own reassociation, AdamW order
        # and association are the only source of drift
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    h = TINY["hidden"]
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            tbert._leaves(tp)):
        t, j = t.numpy(), np.asarray(j)
        if "qkv" in jax.tree_util.keystr(path) and j.ndim == 1:
            # the key third of the qkv bias has an analytically zero
            # gradient (softmax ignores a per-row constant): Adam turns
            # each side's fp32 noise into steps of up to lr in any
            # direction, so it agrees only to 2 x 5 steps x lr
            np.testing.assert_allclose(t[h:2 * h], j[h:2 * h], rtol=0,
                                       atol=10 * LR)
            t, j = np.delete(t, np.s_[h:2 * h]), np.delete(j, np.s_[h:2 * h])
        # 1e-5 relative: AdamW order and association; 1e-6 absolute for
        # elements near zero
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert tst["count"] == 5


def test_train_step_reduces_loss():
    """tests/test_models.py's convergence check, on the port."""
    _, tcfg = _configs(**TINY, remat=False)
    tp = tbert.params_from_numpy(_np_params(_configs(**TINY)[0]), "cpu")
    init, step = tbert.make_train_step(tcfg, learning_rate=1e-2)
    st = init(tp)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(TINY["vocab_size"], 4, 16).items()}
    batch["weights"] = torch.ones(4, 16)
    first = None
    for _ in range(30):
        tp, st, loss = step(tp, st, batch)
        first = float(loss) if first is None else first
    assert float(loss) < first * 0.5
    assert not any(x.requires_grad for x in tbert._leaves(tp))


# ---------------------------------------------------------------------------
# Routing: the streamed route (T > 1024) and the einsum fallback
# ---------------------------------------------------------------------------
ROUTE = dict(vocab_size=32, hidden=16, layers=1, heads=2, mlp_dim=32,
             max_seq=1536, remat=False, attention_impl="flash")


def test_streamed_route_at_t1536_matches_jax():
    jcfg, tcfg = _configs(**ROUTE, causal=True)
    npp = _np_params(jcfg, seed=1)
    batch = _batch(ROUTE["vocab_size"], 1, 1536, seed=1)
    jloss, jgrads = jax.value_and_grad(jbert.lm_loss)(
        _jax_tree(npp), {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    before = ak.flash_forward.launches
    tloss, tgrads = _torch_loss_and_grads(npp, batch, tcfg)
    assert ak.flash_forward.launches == before   # CPU: plain versions
    # fp32 both sides; 512-key blocks there, whole rows here: 1e-6
    # relative on the loss, 1e-5 of each leaf's largest gradient
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    _assert_grads_match(tgrads, jgrads, 1e-5)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_mesh_free_sequence_parallel_impls_are_full(impl):
    _, tcfg = _configs(**TINY, causal=True, attention_impl=impl)
    _, full = _configs(**TINY, causal=True, attention_impl="full")
    tp = tbert.params_from_numpy(_np_params(_configs(**TINY)[0]), "cpu")
    toks = torch.from_numpy(_batch(64, 2, 16)["tokens"])
    assert torch.equal(tbert.forward(tp, toks, tcfg),
                       tbert.forward(tp, toks, full))


def test_infer_last_logits_and_profiler_counts():
    jcfg, tcfg = _configs(**TINY, causal=True)
    npp = _np_params(jcfg)
    toks = _batch(64, 2, 16)["tokens"]
    ref = np.asarray(jbert.make_infer_last_logits(jcfg)(_jax_tree(npp),
                                                        jnp.asarray(toks)))
    tp = tbert.params_from_numpy(npp, "cpu")
    out = tbert.make_infer_last_logits(tcfg)(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    from deeplearning4j_tpu.profiler import profiler as jprof
    assert tprofiler.non_embedding_params(tp, tcfg) == \
        jprof.non_embedding_params(_jax_tree(npp), jcfg)
    assert tprofiler.MFU_BASIS == jprof.MFU_BASIS
    assert tprofiler.transformer_flops_per_token(10, 2, 32, 16) == \
        jprof.transformer_flops_per_token(10, 2, 32, 16)
    assert tprofiler.mfu(1000.0, 2e9, 989e12) == \
        jprof.mfu(1000.0, 2e9, 989e12)
