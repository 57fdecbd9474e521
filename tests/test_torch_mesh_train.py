"""Parity of the port's sharded training (``deeplearning4j_tpu_torch/
models/bert.py`` with ``mesh=``: ``place_params``, ``lm_loss``,
``make_train_step``, ``make_infer_last_logits``) with the JAX package, on
the CPU — the cases of ``tests/test_models.py`` and
``tests/test_sharded_goldens.py``.

The port runs in one spawned gloo world of 8 ranks
(``tests/torch_dist_worker.py``'s ``train`` suite: a ``file://`` store
under ``tmp_path``, one CPU thread a rank, no ``jax``); a mesh smaller
than 8 takes the first ranks. The world starts when the module's first
test asks for it and runs while the JAX side computes. Parameters and
batches are the same seeded numpy arrays on both sides, fp32, remat off
(as the reference's mesh tests). The JAX package's steps run on the
conftest's 8 virtual CPU devices, its Pallas kernels in interpret mode.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

import torch_dist_worker as W
from torch_threads import one_torch_thread  # noqa: F401,E402

TIMEOUT = 300.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World("train", 8, tmp_path_factory.mktemp("torch_mesh_train"),
                TIMEOUT)
    yield w
    w.close()


def _jcfg(cfg, impl, causal):
    return jbert.TransformerConfig(dtype=jnp.float32, attention_impl=impl,
                                   causal=causal, **cfg)


def _jtree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def _sharded(mesh, batch):
    bsh = NamedSharding(mesh, jbert.batch_pspec(mesh))
    return {k: jax.device_put(jnp.asarray(v), bsh) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_grads(causal):
    """The JAX package's single-device loss and gradients on the cases'
    params and batch: the oracle of every mesh shape (``"full"``
    attention; every route computes the same function)."""
    cfg = _jcfg(W.TINY, "full", causal)
    batch = W.np_batch(W.TINY["vocab_size"], 4, 16, 1)
    loss, grads = jax.jit(jax.value_and_grad(jbert.lm_loss),
                          static_argnums=2)(
        _jtree(W.np_params(W.TINY, 0)),
        {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    return float(loss), [np.asarray(g) for g in
                         jax.tree_util.tree_leaves(grads)]


CASES = [pytest.param(s, i, c, id=cid) for cid, s, i, c in W.TRAIN_CASES]


@pytest.mark.parametrize("shape,impl,causal", CASES)
def test_loss_and_grads_match_jax(world, shape, impl, causal):
    """Per-rank ``lm_loss`` under the mesh, its gradients summed over
    data and context and gathered over model, against the JAX package's
    loss and gradients: loss within 1e-5 relative, each leaf within 1e-5
    of its largest |gradient| (fp32; sums reassociate across ranks)."""
    cid = next(c for c, s, i, k in W.TRAIN_CASES
               if (s, i, k) == (shape, impl, causal))
    got = world.case(f"train-{cid}")
    loss, grads = _jax_grads(causal)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert len(got["grads"]) == len(grads)
    for a, b in zip(got["grads"], grads):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-6))


@pytest.mark.parametrize("shape,impl,causal", CASES)
def test_train_step_matches_jax_on_same_mesh(world, shape, impl, causal):
    """One ``make_train_step(cfg, mesh)`` step (AdamW, lr 1e-3) against
    the JAX package's ``make_train_step`` on the same mesh shape and
    attention route: the loss within 1e-5 relative, every updated
    parameter within 2e-5 (the reference's sharded-step bound)."""
    cid = next(c for c, s, i, k in W.TRAIN_CASES
               if (s, i, k) == (shape, impl, causal))
    cfg = _jcfg(W.TINY, impl, causal)
    mesh = jax_make_mesh(dict(shape))
    init, step = jbert.make_train_step(cfg, mesh, learning_rate=W.LR)
    params = jbert.place_params(_jtree(W.np_params(W.TINY, 0)), cfg, mesh)
    params, _, loss = step(params, init(params), _sharded(
        mesh, W.np_batch(W.TINY["vocab_size"], 4, 16, 1)))
    got = world.case(f"train-{cid}")
    np.testing.assert_allclose(got["step_loss"], float(loss), rtol=1e-5)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(got["params"]) == len(leaves)
    for a, b in zip(got["params"], leaves):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)


def test_infer_last_logits_under_mesh_matches_jax(world):
    """``make_infer_last_logits(cfg, mesh)`` on a 2x2x2 mesh (the ring
    route, causal) gives every rank the whole (B, vocab) last-position
    logits, equal to the JAX package's on the same mesh within 2e-5; the
    per-rank ``forward`` block is the JAX forward's block."""
    cfg = _jcfg(W.TINY, "ring", True)
    mesh = jax_make_mesh({"data": 2, "model": 2, "context": 2})
    params = jbert.place_params(_jtree(W.np_params(W.TINY, 3)), cfg, mesh)
    tokens = W.np_batch(W.TINY["vocab_size"], 4, 16, 4)["tokens"]
    want = np.asarray(jbert.make_infer_last_logits(cfg, mesh)(
        params, jnp.asarray(tokens)))
    full = np.asarray(jbert.forward(params, jnp.asarray(tokens), cfg, mesh))
    got = world.case("infer")
    np.testing.assert_allclose(got["last"], want, atol=2e-5)
    d, c = got["coord"]
    np.testing.assert_allclose(got["block"],
                               full[d * 2:(d + 1) * 2, c * 8:(c + 1) * 8],
                               atol=2e-5)


def test_packed_mesh_spec_refusals_match_jax(world):
    """``_packed_mesh_spec`` / ``_use_packed_kernel`` on the reference
    test's meshes: None where the sequence is split or batch or heads do
    not divide; per-rank heads on (data, model); a context axis of 1 is
    harmless — the JAX package's answers."""
    from deeplearning4j_tpu.models.bert import (
        _packed_mesh_spec, _use_packed_kernel)

    cfg = _jcfg(W.TINY, "flash", False)
    got = world.case("refusal")
    assert got["dc"] is None and got["m8"] is None and got["d8"] is None
    assert _packed_mesh_spec(cfg, jax_make_mesh({"model": 8}), 8) is None
    spec, heads = _packed_mesh_spec(cfg, jax_make_mesh({"data": 2,
                                                        "model": 2}), 4)
    assert got["dm_spec"] == tuple(spec) and got["dm_heads"] == heads == 2
    assert got["use_dm"] and not got["use_d8"] and got["use_dmc1"]
    assert _use_packed_kernel(cfg, jax_make_mesh({"data": 2, "model": 2}),
                              4, 16)
    assert not _use_packed_kernel(cfg, jax_make_mesh({"data": 8}), 4, 16)


@functools.lru_cache(maxsize=None)
def _jax_golden():
    """The JAX package's 2x2x2 ring trajectory on the golden task."""
    cfg = _jcfg(W.GOLDEN, "ring", False)
    mesh = jax_make_mesh({"data": 2, "model": 2, "context": 2})
    params = jbert.place_params(_jtree(W.np_params(W.GOLDEN, 0)), cfg, mesh)
    init, step = jbert.make_train_step(cfg, mesh, learning_rate=W.LR)
    state = init(params)
    losses = []
    ones = np.ones((W.GOLDEN_B, W.GOLDEN_T), np.float32)
    for tokens, targets in W.golden_batches():
        params, state, loss = step(params, state, _sharded(mesh, {
            "tokens": tokens, "targets": targets, "weights": ones}))
        losses.append(float(loss))
    flat = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(params)])
    return np.asarray(losses), flat


def test_golden_2x2x2_trajectory_losses(world):
    """tests/test_sharded_goldens.py's 50-step dp x tp x sp (ring)
    trajectory: 8 gloo ranks against the JAX package's 2x2x2 run, every
    step's loss within the reference's rtol 5e-3, and training makes
    progress."""
    got = world.case("golden")
    losses, _ = _jax_golden()
    assert got["losses"][-1] < 0.75 * got["losses"][0]
    np.testing.assert_allclose(got["losses"], losses, rtol=5e-3)


def test_golden_2x2x2_trajectory_params(world):
    """The same trajectory's end-state parameters within the reference's
    atol 2e-3."""
    got = world.case("golden")
    _, params = _jax_golden()
    np.testing.assert_allclose(got["params"], params, atol=2e-3)


def test_world_one_mesh_step_is_the_meshless_step():
    """Without a process group a mesh has every axis 1: ``place_params``
    copies the tree, and ``make_train_step(cfg, mesh)`` gives the
    meshless step's losses and parameters bit for bit (the packed route,
    three steps) — what the card's ``mesh`` phase checks at full width."""
    cfg = tbert.TransformerConfig(dtype=torch.float32, attention_impl="flash",
                                  **W.TINY)
    mesh = make_mesh({"data": 1, "model": 1, "context": 1})
    batch = {k: torch.from_numpy(v) for k, v in
             W.np_batch(W.TINY["vocab_size"], 4, 16, 1).items()}
    runs = []
    for m in (None, mesh):
        params = tbert.params_from_numpy(W.np_params(W.TINY, 0),
                                         device="cpu")
        if m is not None:
            params = tbert.place_params(params, cfg, m)
        init, step = tbert.make_train_step(cfg, m, learning_rate=W.LR)
        state = init(params)
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        runs.append((losses, tbert._leaves(params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_place_params_refuses_unsplittable_widths():
    cfg = tbert.TransformerConfig(dtype=torch.float32, **{**W.TINY,
                                                          "heads": 3,
                                                          "hidden": 30})

    class Two:   # a mesh stand-in with a model axis of 2
        shape = {"model": 2}

        def axis_size(self, axis):
            return self.shape.get(axis, 1)

    with pytest.raises(ValueError, match="heads=3"):
        tbert.place_params({}, cfg, Two())


def test_worker_imports_no_jax(world):
    assert world.results()["_jax_imported"] == []
