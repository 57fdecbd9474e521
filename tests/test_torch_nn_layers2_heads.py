"""The second half's recurrent extras (GravesBidirectionalLSTM,
LearnedSelfAttentionLayer, RecurrentAttentionLayer), capsules, heads
(CenterLossOutputLayer, OCNNOutputLayer, Yolo2OutputLayer) and
autoencoders against the JAX package's on the CPU: each layer through
the harness of ``tests/torch_nn_parity.py`` (1e-5 forward, 1e-4
gradients, relative to the largest |value|; the sequence cases with a
features mask too), and each head's loss and its gradients on the same
inputs. Networks ending in each head, and the autoencoders'
pretraining, are in ``tests/test_torch_nn_heads_train.py``. The port's
64-bit switch is on, as the suite runs the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

import torch_nn_cases as C
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

IDS = C.SECOND_HALF_IDS[C.SECOND_HALF_IDS.index("graves_bidirectional_lstm"):]
REL = 1e-5


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


@pytest.mark.parametrize("case_id,training,masked", list(H.variants(IDS)))
def test_layer_forward_and_gradients(case_id, training, masked):
    H.check_case(case_id, training, masked)


def _head_labels(case_id, out_shape):
    rng = np.random.default_rng(4)
    if case_id == "yolo2_output":
        B, _, Hh, W = out_shape
        lab = np.zeros((B, 4 + 2, Hh, W), np.float32)
        lab[:, 0:2] = rng.uniform(0.1, 0.9, (B, 2, Hh, W))
        lab[:, 2:4] = rng.uniform(0.5, 2.5, (B, 2, Hh, W))
        cls = rng.integers(0, 2, (B, Hh, W))
        present = rng.uniform(size=(B, Hh, W)) < 0.5
        for c in range(2):
            lab[:, 4 + c] = (cls == c) & present
        return lab
    return np.eye(out_shape[-1], dtype=np.float32)[rng.integers(0, out_shape[-1],
                                                               out_shape[0])]


@pytest.mark.parametrize("case_id", ["center_loss_output", "ocnn_output", "yolo2_output"])
def test_head_loss_and_gradients(case_id):
    """The head's training loss (center loss with its features, OCNN's
    objective with r, the YOLOv2 grid loss) and its gradients with
    respect to the parameters and the input."""
    jl, _ = C.build(jnn, case_id)
    pl, _ = C.build(pnn, case_id)
    params = H.np_tree(jl.init_params(jax.random.key(H.INIT_KEY), jnp.float32))
    if case_id == "center_loss_output":  # centers away from zero
        params["centers"] = np.random.default_rng(5).standard_normal(
            params["centers"].shape).astype(np.float32)
    x, _ = C.inputs(case_id)

    def jloss(p, x, y):
        out, st = jl.apply(p, x, training=True)
        if case_id == "center_loss_output":
            return jl.compute_loss_ext(p, y, out, st["features"])
        if case_id == "ocnn_output":
            return jl.loss_with_params(p, y, out) + jl.compute_loss(y, out)
        return jl.compute_loss(y, out)

    out_shape = np.asarray(jl.apply(params, x)[0]).shape
    y = _head_labels(case_id, out_shape)
    want, (wg, wx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, x, y)

    tp = tree_map(lambda a: torch.tensor(a).requires_grad_(), params)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y)
    out, st = pl.apply(tp, xt, training=True)
    if case_id == "center_loss_output":
        got = pl.compute_loss_ext(tp, yt, out, st["features"])
    elif case_id == "ocnn_output":
        got = pl.loss_with_params(tp, yt, out) + pl.compute_loss(yt, out)
    else:
        got = pl.compute_loss(yt, out)
    grads = torch.autograd.grad(got, tree_leaves(tp) + [xt])
    H.close(got.detach().numpy(), np.asarray(want), REL, f"{case_id} loss")
    for a, b in zip(grads, jax.tree_util.tree_leaves(wg) + [wx]):
        H.close(a.numpy(), b, H.GRAD_REL, f"{case_id} gradient")
    if case_id == "yolo2_output":
        dets = pl.getPredictedObjects(out.detach(), threshold=0.2)
        ref = jl.getPredictedObjects(np.asarray(jl.apply(params, x)[0]), threshold=0.2)
        assert [len(d) for d in dets] == [len(d) for d in ref]
        for a, b in zip(sum(dets, []), sum(ref, [])):
            np.testing.assert_allclose(a[:5], b[:5], rtol=1e-5, atol=1e-6)
            assert a[5] == b[5]
